"""Tiny cells for the CPU tests: a copy of portbench/ under a temporary
root, with a BENCHMARK.json whose cells are tiny versions of each kind's
configurations and mixes, added as new files only (as a later change
adds a configuration, a mix, a cell, a metric or a kernel class)."""
from __future__ import annotations

import io
import json
import shutil
from contextlib import redirect_stdout
from pathlib import Path

PB = Path(__file__).resolve().parent.parent

TINY_DENSE = {
    "name": "tiny_dense", "source": "tests", "hidden_size": 64, "intermediate_size": 128,
    "max_position_embeddings": 256, "num_attention_heads": 4,
    "num_hidden_layers": 2, "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "sliding_window": 16, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "vocab_size": 256,
}
TINY_MOE = dict(TINY_DENSE, name="tiny_moe", sliding_window=None,
                tie_word_embeddings=False, num_local_experts=4,
                num_experts_per_tok=2, rope_theta=1000000.0,
                quantization={"weights": "int8"})
TINY_TRAIN = {
    "kind": "train_lm", "batch": 2, "seq_len": 40,
    "optimizer": {"name": "adafactor", "learning_rate": 0.001},
    "remat": True, "attention": "flash", "check_steps": 2,
    "kernel_sources": ["flash_attention"],
}
TINY_SERVE = {
    "kind": "serve_lm", "requests_per_call": 12,
    "prompt_tokens": {"dist": "lognormal", "median": 20, "sigma": 0.6,
                      "min": 6, "max": 48},
    "new_tokens": {"dist": "uniform", "min": 8, "max": 16},
    "serve": {"scheduler": "continuous", "slots": 4, "prefill_chunk": 16,
              "block_size": 8, "steps_per_sync": 4},
    "warmup": {"requests": 2, "new_tokens": 3},
    "check": {"requests": 12},
    "kernel_sources": ["paged_attention"],
}
CELLS = {
    "tiny_dense.train": ("tiny_dense", "tiny.train", TINY_TRAIN,
                         ["loss_gap", "grad1_gap", "change_gap"]),
    "tiny_moe.serve": ("tiny_moe", "tiny.serve", TINY_SERVE, ["mean_gap"]),
    # bfloat16 weights and a sliding window through the same serving kind
    "tiny_dense.serve": ("tiny_dense", "tiny.serve", TINY_SERVE,
                         ["mean_gap"]),
}
# the serving kind's metrics, entries a serving cell adds with its files
SERVE_METRICS = {
    "end_to_end": [
        {"name": "serve_tokens_per_s", "unit": "tokens/s", "better": "higher",
         "bound": 0.05, "source": "host_clock"},
        {"name": "tpot_p90_ms", "unit": "ms", "better": "lower",
         "bound": 0.05, "source": "host_clock"},
        {"name": "ttft_p90_s", "unit": "s", "better": "lower",
         "bound": 0.05, "source": "host_clock"}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": moves}
        for name, unit, better, source, layer, moves in (
            ("decode_step_ms.serve", "ms", "lower", "program_span",
             "Scheduler", "tpot_p90_ms"),
            ("mfu.serve", "%", "higher", "host_clock", "Model call",
             "serve_tokens_per_s"),
            ("moe_share.serve", "%", "lower", "device_trace", "Experts",
             "serve_tokens_per_s"),
            ("k1_roofline.serve", "%", "higher", "device_trace", "Kernels",
             "serve_tokens_per_s"),
            ("device_idle.serve", "%", "lower", "device_trace", "Device",
             "serve_tokens_per_s"))]}
# limits loose enough for any sound tiny run: the tests that break the
# program check that a fault still crosses them
LIMITS = {"loss_gap": 0.05, "grad1_gap": 0.05, "change_gap": 0.05,
          "mean_gap": 0.08}


def make_root(tmp: Path, limits=None) -> Path:
    """tmp/root holding BENCHMARK.json and portbench/ with the tiny cells
    added as new files; returns the root."""
    limits = dict(LIMITS, **(limits or {}))
    root = tmp / "root"
    pb = root / "portbench"
    shutil.copytree(PB, pb, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache", "tests"))
    (pb / "configs" / "tiny_dense.json").write_text(json.dumps(TINY_DENSE))
    (pb / "configs" / "tiny_moe.json").write_text(json.dumps(TINY_MOE))
    manifest = json.loads((PB.parent / "BENCHMARK.json").read_text())
    manifest["workloads"] = []
    for cell, (config, tname, traffic, checks) in CELLS.items():
        (pb / "traffic" / f"{tname}.json").write_text(json.dumps(traffic))
        (pb / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"name": cell, "config": config, "traffic": tname,
             "limits": {k: limits[k] for k in checks}}))
        manifest["workloads"].append(
            {"name": cell, "config": config, "traffic": tname, "chips": 1,
             "why": "a CPU rehearsal"})
    kinds = {cell: cell.rsplit(".", 1)[1] for cell in CELLS}
    for key in ("end_to_end", "per_layer"):
        for m in manifest[key]:
            if "workloads" in m:
                m["workloads"] = [c for c, k in kinds.items() if k == "train"]
        manifest[key] += [
            dict(m, workloads=[c for c, k in kinds.items() if k == "serve"])
            for m in SERVE_METRICS[key]]
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def run_cell(root: Path, cell: str, seed: int = 123456789012,
             seconds: float = 0.5, trace: int = 0) -> dict:
    """One CPU run of a tiny cell through portbench's own entry; the
    result line as a dict."""
    from portbench.harness import core

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = core.run(["--workload", cell, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      root=root, pb=root / "portbench", device="cpu")
    assert rc == 0, rc
    return json.loads(buf.getvalue().strip().splitlines()[-1])
