"""The port's entry points with checkpoints and records: train_llama
(--data-dir, --ckpt-dir, --save-interval, SIGTERM), generate_llama and
serve_llama (--ckpt-dir, dense and --paged) against the JAX package's
examples/llama scripts, on the CPU at the tiny f32 smoke widths.

The CLI parity gate: a checkpoint written by the port's Checkpointer
holding the JAX smoke weights (model.init(PRNGKey(0)) of JAX's
resolve_config(--smoke), carried over by the bridge) makes the port's
generate_llama and serve_llama print the greedy tokens and request lines
of JAX's scripts run with --smoke, dense and paged.  serve_loop is
wrapped on both sides to read the tokens, which the request lines only
show decoded.
"""
import dataclasses
import importlib.util
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu_torch import generate_llama, serve_llama
from tf_operator_tpu_torch import train_llama as ttl
from tf_operator_tpu_torch.data.loader import FieldSpec, write_records
from tf_operator_tpu_torch.models import bridge, llama as tl
from tf_operator_tpu_torch.runtime import optim
from tf_operator_tpu_torch.runtime.loop import PreemptionGuard
from tf_operator_tpu_torch.runtime.train import Checkpointer, TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["hello", "the quick brown fox", "hi"]
SERVE = ["--max-new", "8", "--slots", "2"] + [
    a for p in PROMPTS for a in ("--prompt", p)]
PAGED = ["--paged", "--block-size", "4"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny tensors: one torch thread (the count is put back after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "examples/llama", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording(mod):
    """Wrap mod.serve_loop; returns the list each call's tokens go to."""
    seen = []
    inner = mod.serve_loop

    def serve_loop(*a, **kw):
        res = inner(*a, **kw)
        seen.append([[int(t) for t in r.tokens] for r in res])
        return res

    mod.serve_loop = serve_loop
    return seen


def _request_lines(out: str):
    """The per-request lines (schedule and decoded text); the summary
    line carries wall-clock rates and is left out."""
    return [l for l in out.splitlines()
            if l.startswith("--- request") or l.startswith("    ")]


def _tokens(out: str):
    line = [l for l in out.splitlines() if l.startswith("tokens: ")][-1]
    return [int(t) for t in line[len("tokens: ["):-1].split(", ")]


@pytest.fixture(scope="module")
def jax_cli():
    """JAX's scripts with --smoke: generate's tokens; serve's request
    lines and tokens, dense and paged."""
    import contextlib
    import io

    gen, serve = _jax_script("generate_llama"), _jax_script("serve_llama")
    out = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert gen.main(["--smoke", "--prompt", PROMPTS[1],
                         "--max-new", "8"]) == 0
    out["generate"] = _tokens(buf.getvalue())
    seen = _recording(serve)  # serve_llama imports serve_loop by name
    for mode, extra in (("dense", []), ("paged", PAGED)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert serve.main(["--smoke"] + SERVE + extra) == 0
        out[mode] = (_request_lines(buf.getvalue()), seen[-1])
    return out


@pytest.fixture(scope="module")
def jax_weights_ckpt(tmp_path_factory):
    """A port checkpoint (step 7) holding the JAX smoke weights."""
    jgen = _jax_script("generate_llama")
    args = type("A", (), {"smoke": True, "model": "llama3", "hf_dir": ""})
    cfg_j = jgen.resolve_config(args)
    params = jgen.Llama(cfg_j).init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 8), jnp.int32),
                                    train=False)["params"]
    cfg = tl.tiny(tie_embeddings=True, dtype=torch.float32, max_len=256)
    model = tl.Llama.from_params(
        cfg, bridge.params_from_jax(cfg, jax.tree.map(np.asarray, params),
                                    train=True),
        device="cpu", train=True)
    state = TrainState.create(model, optim.Adafactor(1e-3))
    state.step = 7
    path = str(tmp_path_factory.mktemp("jax_weights"))
    assert Checkpointer(path).save(7, state)
    return path


def test_generate_llama_from_a_checkpoint_gives_jax_tokens(
        jax_cli, jax_weights_ckpt, capsys):
    argv = ["--smoke", "--device", "cpu", "--ckpt-dir", jax_weights_ckpt,
            "--prompt", PROMPTS[1], "--max-new", "8"]
    assert generate_llama.main(argv) == 0
    out = capsys.readouterr().out
    assert f"restored step 7 from {jax_weights_ckpt}" in out
    assert _tokens(out) == jax_cli["generate"]
    # without the checkpoint, the port's seeded weights decode otherwise
    assert generate_llama.main(argv[:3] + argv[5:]) == 0
    assert _tokens(capsys.readouterr().out) != jax_cli["generate"]


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_serve_llama_from_a_checkpoint_prints_jax_lines(
        jax_cli, jax_weights_ckpt, capsys, monkeypatch, mode):
    seen = []
    inner = serve_llama.serve_loop

    def serve_loop(*a, **kw):
        seen.append(kw["paged"])
        res = inner(*a, **kw)
        seen.append([[int(t) for t in r.tokens] for r in res])
        return res

    monkeypatch.setattr(serve_llama, "serve_loop", serve_loop)
    extra = PAGED if mode == "paged" else []
    assert serve_llama.main(["--smoke", "--device", "cpu", "--ckpt-dir",
                             jax_weights_ckpt] + SERVE + extra) == 0
    out = capsys.readouterr().out
    lines, tokens = jax_cli[mode]
    assert seen[0] is (mode == "paged")
    assert seen[1] == tokens
    assert _request_lines(out) == lines
    assert "3 requests, 24 tokens through 2 lanes in" in out
    # greedy: the paged run's tokens are the dense run's and generate's
    assert tokens == jax_cli["dense"][1]
    assert tokens[1] == jax_cli["generate"]


def test_serve_llama_options_on_the_cpu(jax_weights_ckpt, capsys):
    """int8 weights and KV, a system prompt, chunked prefill, a draft
    from the checkpoint, and seeded sampling all run; greedy speculation
    keeps the plain tokens."""
    base = ["--smoke", "--device", "cpu", "--ckpt-dir", jax_weights_ckpt]
    assert serve_llama.main(base + SERVE + ["--draft-ckpt-dir",
                                            jax_weights_ckpt]) == 0
    out = capsys.readouterr().out
    assert "speculative serving: 1-layer draft, k=4" in out
    assert "acceptance" in out
    spec_lines = _request_lines(out)
    assert serve_llama.main(base + SERVE) == 0
    plain = _request_lines(capsys.readouterr().out)
    assert [l for l in spec_lines if l.startswith("    ")] == \
        [l for l in plain if l.startswith("    ")]
    assert serve_llama.main(base + SERVE + PAGED + [
        "--int8", "--int8-kv", "--system-prompt", "be brief",
        "--prefill-chunk", "4", "--prefill-chunks-per-sync", "1"]) == 0
    out = capsys.readouterr().out
    assert "weights: int8" in out and "kv caches: int8" in out
    assert "system prompt: 8 tokens, prefilled once" in out
    run = lambda seed: _request_lines((serve_llama.main(
        base + SERVE + ["--temperature", "0.9", "--seed", str(seed)]),
        capsys.readouterr().out)[1])
    assert run(3) == run(3)


@pytest.mark.parametrize("kernel", ["pallas", "gather"])
def test_serve_llama_refuses_tpu_read_paths(kernel):
    with pytest.raises(SystemExit, match=f"--paged-kernel {kernel}: .* "
                       "TPU-side read path .* K1/K1q"):
        serve_llama.main(["--smoke", "--device", "cpu", "--prompt", "hi",
                          "--paged", "--paged-kernel", kernel])


@pytest.mark.parametrize("argv,exc,match", [
    ([], SystemExit, "no requests: pass --prompt"),
    (["--prompt", "hi", "--no-smoke"], SystemExit, "no weights: pass"),
    (["--prompt", "hi", "--hf-dir", "x"], NotImplementedError, "item 10"),
    (["--prompt", "hi", "--model", "mixtral"], NotImplementedError,
     "item 10"),
])
def test_serve_llama_refusals(argv, exc, match):
    smoke = ["--smoke"] if "--no-smoke" not in argv else []
    argv = [a for a in argv if a != "--no-smoke"]
    with pytest.raises(exc, match=match):
        serve_llama.main(smoke + ["--device", "cpu"] + argv)


def test_checkpoint_loaders_refuse_an_empty_directory(tmp_path):
    for main in (generate_llama.main, serve_llama.main):
        with pytest.raises(SystemExit,
                           match=f"no checkpoint under {tmp_path}"):
            main(["--device", "cpu", "--ckpt-dir", str(tmp_path),
                  "--prompt", "hi"])
    with pytest.raises(SystemExit, match=f"no checkpoint under {tmp_path}"):
        generate_llama.main(["--smoke", "--device", "cpu", "--prompt", "hi",
                             "--draft-ckpt-dir", str(tmp_path)])


def test_int8_quantizes_after_the_load(jax_weights_ckpt):
    """--int8 quantizes the checkpoint's f32 parameters: the weights are
    quant.quantize_params of what restore_params reads."""
    from tf_operator_tpu_torch.models import quant

    cfg = tl.tiny(tie_embeddings=True, dtype=torch.float32, max_len=256)
    got = generate_llama.load_params(cfg, jax_weights_ckpt,
                                     torch.device("cpu"), int8=True)
    want = quant.quantize_params(
        Checkpointer(jax_weights_ckpt).restore_params())
    for k, v in want.items():
        if isinstance(v, quant.QTensor):
            assert torch.equal(got[k].q, v.q) and torch.equal(got[k].scale,
                                                              v.scale), k
        else:
            assert torch.equal(got[k], v), k
    d = generate_llama.build_draft(
        type("A", (), {"draft_layers": 1, "draft_ckpt_dir": "",
                       "smoke": True, "int8": False}), cfg,
        torch.device("cpu"))
    assert d.cfg == dataclasses.replace(cfg, n_layers=1)


# ----------------------------------------------------------- train_llama
def _shards(path, n_files=2, rows=6, seq=16):
    rng = np.random.default_rng(11)
    for i in range(n_files):
        write_records(str(path / f"part-{i}.rec"),
                      [FieldSpec("tokens", (seq,), "int32")],
                      {"tokens": rng.integers(0, 256, (rows, seq))})


def _train_argv(data, ckpt, steps):
    return ["--smoke", "--device", "cpu", "--data-dir", str(data),
            "--ckpt-dir", str(ckpt), "--steps", str(steps),
            "--save-interval", "1", "--per-host-batch", "2",
            "--seq-len", "16"]


def test_train_llama_saves_and_resumes_from_records(tmp_path, capsys):
    data, ckpt = tmp_path / "data", tmp_path / "ckpt"
    data.mkdir()
    _shards(data)
    assert ttl.main(_train_argv(data, ckpt, 2)) == 0
    out = capsys.readouterr().out
    assert "data: records x12 (shard 0/1)" in out
    assert "complete: steps=2 resumed_from=None loss=" in out
    assert Checkpointer(str(ckpt)).all_steps() == [1, 2]
    assert ttl.main(_train_argv(data, ckpt, 4)) == 0
    out = capsys.readouterr().out
    assert "complete: steps=2 resumed_from=2 loss=" in out
    assert Checkpointer(str(ckpt)).all_steps() == [2, 3, 4]
    # the trained weights reach serving
    assert generate_llama.main(["--smoke", "--device", "cpu", "--ckpt-dir",
                                str(ckpt), "--prompt", "hi",
                                "--max-new", "4"]) == 0
    assert f"restored step 4 from {ckpt}" in capsys.readouterr().out


def test_train_llama_sigterm_saves_the_step_reached(tmp_path, capsys,
                                                    monkeypatch):
    """A SIGTERM (the guard's trigger) after the third batch: the loop
    stops, saves once more, and prints JAX's words; the checkpoint holds
    the step reached, and the process's SIGTERM handler is put back."""
    data, ckpt = tmp_path / "data", tmp_path / "ckpt"
    data.mkdir()
    _shards(data)
    guards = []

    class Guard(PreemptionGuard):
        def __init__(self, install=True):
            super().__init__(install=install)
            guards.append(self)

    inner = ttl.token_record_pipeline

    def pipeline(*a, **kw):
        for i, batch in enumerate(inner(*a, **kw)):
            if i == 3:
                guards[0].trigger()
            yield batch

    monkeypatch.setattr(ttl, "PreemptionGuard", Guard)
    monkeypatch.setattr(ttl, "token_record_pipeline", pipeline)
    before = signal.getsignal(signal.SIGTERM)
    argv = _train_argv(data, ckpt, 100)
    argv[argv.index("--save-interval") + 1] = "50"
    assert ttl.main(argv) == 143
    out = capsys.readouterr().out
    assert "preempted (checkpointed): steps=4 resumed_from=None" in out
    assert Checkpointer(str(ckpt)).latest_step() == 4
    assert signal.getsignal(signal.SIGTERM) is before


def test_train_llama_mistral_smoke_trains_windowed(capsys, monkeypatch):
    """--model mistral --smoke: the tiny model at window 16 trains over a
    sequence the window cuts."""
    seen = []
    inner = ttl.make_lm_step

    def make_lm_step(model):
        seen.append(model.cfg.sliding_window)
        return inner(model)

    monkeypatch.setattr(ttl, "make_lm_step", make_lm_step)
    assert ttl.main(["--smoke", "--device", "cpu", "--model", "mistral",
                     "--steps", "2", "--per-host-batch", "2",
                     "--seq-len", "48"]) == 0
    out = capsys.readouterr().out
    assert "model mistral (smoke), 2 layers, batch 2 x 48" in out
    assert "complete: steps=2 resumed_from=None loss=" in out
    assert seen == [16]
