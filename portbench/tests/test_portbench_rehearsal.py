"""Each kind's whole run on the CPU at a tiny size, through portbench's
own entry: tiny cells added as new files only (a configuration, a mix,
a cell, a per-layer metric and a kernel class), their runs correct, and
the same runs with the timed path broken underneath coming out not
correct, once for each fault a cell of the kind can have."""
import json
import subprocess
import sys

import pytest
import torch

from portbench.tests import tiny

TRAIN, SERVE, SERVE_BF16 = "tiny_dense.train", "tiny_moe.serve", \
    "tiny_dense.serve"
SERVE_E2E = {"setup_s", "serve_tokens_per_s", "tpot_p90_ms", "ttft_p90_s"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("portbench"))


def test_tiny_cells_are_correct(root):
    for cell, e2e in ((TRAIN, {"setup_s", "train_tokens_per_s"}),
                      (SERVE, SERVE_E2E), (SERVE_BF16, SERVE_E2E)):
        line = tiny.run_cell(root, cell)
        assert line["correct"], line
        assert set(line["metrics"]) == e2e
        assert line["attempted"] > 0 and line["failed"] == 0
        assert list(line)[-1] == "checks"


def test_traced_runs_report_per_layer_metrics(root):
    train = tiny.run_cell(root, TRAIN, trace=1)
    assert train["correct"] and "mfu.train" in train["metrics"]
    assert {"busy_s", "window_s"} <= set(train["device"])
    assert set(train["breakdown"]) == {"device_ops", "idle_gaps"}
    serve = tiny.run_cell(root, SERVE, trace=1)
    assert serve["correct"]
    assert {"mfu.serve", "decode_step_ms.serve"} <= set(serve["metrics"])
    # no device trace on the CPU: the readers of device time find
    # nothing and leave their metrics out
    assert "k1_roofline.serve" not in serve["metrics"]


def test_a_new_metric_and_kernel_class_are_found_by_name(root):
    pb = root / "portbench"
    (pb / "metrics" / "steps.train.py").write_text(
        "def read(r):\n    return r['work']['steps'] if r.get('kind') == "
        "'train_lm' else None\n")
    (pb / "kernels" / "norm.py").write_text(
        "SOURCE = None\nPATTERNS = ('rms',)\n\ndef bound(work):\n"
        "    return None\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["per_layer"].append(
        {"name": "steps.train", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "Train step",
         "moves": "train_tokens_per_s", "workloads": [TRAIN]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    try:
        line = tiny.run_cell(root, TRAIN, trace=1)
        assert line["metrics"]["steps.train"]["value"] >= 1
        from portbench.harness.core import Bench

        assert "norm" in Bench(root, pb).kernel_classes()
    finally:
        manifest["per_layer"].pop()
        (root / "BENCHMARK.json").write_text(json.dumps(manifest))
        (pb / "metrics" / "steps.train.py").unlink()
        (pb / "kernels" / "norm.py").unlink()


def _unchanged_update(self, params, state, layout=None):
    for p in params.values():
        p.grad = None
    state["count"] += 1
    return state


def _half_batch_step(make):
    def make_half(model):
        step = make(model)

        def half(state, tokens):
            return step(state, tokens[: tokens.shape[0] // 2])
        return half
    return make_half


def test_training_faults_are_not_correct(root, monkeypatch):
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.runtime import optim

    with monkeypatch.context() as m:
        m.setattr(optim.Adafactor, "update_", _unchanged_update)
        line = tiny.run_cell(root, TRAIN)
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    with monkeypatch.context() as m:
        m.setattr(train_llama, "make_lm_step",
                  _half_batch_step(train_llama.make_lm_step))
        line = tiny.run_cell(root, TRAIN)
    assert not line["correct"]
    assert line["checks"]["grad1_gap"]["value"] > 0.05


def test_serving_fault_is_not_correct(root, monkeypatch):
    from tf_operator_tpu_torch.models import llama

    select = llama._select_token

    def altered(logits, *a, **kw):
        # the token is altered where it is produced: the second best
        return torch.topk(logits, 2, dim=-1).indices[..., 1]

    with monkeypatch.context() as m:
        m.setattr(llama, "_select_token", altered)
        line = tiny.run_cell(root, SERVE)
    assert llama._select_token is select
    assert not line["correct"]
    assert line["checks"]["mean_gap"]["value"] > tiny.LIMITS["mean_gap"]


def _control(root, cell):
    out = subprocess.run(
        [sys.executable, str(root / "portbench" / "checks" / "control.py"),
         "--workload", cell, "--seeds", "7"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": str(tiny.PB.parent), "PATH": "/usr/bin:/bin",
             "HOME": str(root)})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_training_control_and_half_batch_fail_the_limits(root):
    r = _control(root, TRAIN)
    limits = tiny.LIMITS
    for name in ("control", "half"):
        assert any(r[name][k] > limits[k]
                   for k in ("loss_gap", "grad1_gap", "change_gap")), r


def test_serving_control_fails_the_limit(root):
    r = _control(root, SERVE)
    assert r["control"]["mean"] > tiny.LIMITS["mean_gap"] > r["program"]["mean"]
