"""One run of one cell: the manifest, the files found by name, the
checks every run makes, and the result line.

Everything that belongs to one configuration, traffic mix, cell,
per-layer metric, kernel class or kind of traffic sits in a file of its
own under portbench/, found by its name:

  configs/<config>.json     the configuration as it is run
  traffic/<traffic>.json    a mix's parameters; its "kind" names the runner
  workloads/<cell>.json     the cell's limits of the correctness check
  kinds/<kind>.py           the runner of a kind of traffic: run(ctx)
  metrics/<metric>.py       a per-layer metric's reader: read(readings)
  kernels/<class>.py        a kernel class: PATTERNS, SOURCE, bound(work)
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PB = Path(__file__).resolve().parent.parent
# modules whose presence in a run means the JAX package or JAX was loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tf_operator_tpu")


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that are forbidden, compared
    whole (tf_operator_tpu_torch is not tf_operator_tpu)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def load_module(path: Path) -> ModuleType:
    """A Python file by path (metric and kernel files have dots in
    their names, so they are no importable module names)."""
    name = "portbench_file_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The manifest and the files under portbench/ (or another root
    holding the same layout: the tests' copies)."""

    def __init__(self, root: Path, pb: Path = PB):
        self.root = Path(root)
        self.pb = Path(pb)
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, sub: str, name: str) -> dict:
        return json.loads((self.pb / sub / f"{name}.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._json("workloads", name)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def kind(self, name: str) -> ModuleType:
        return load_module(self.pb / "kinds" / f"{name}.py")

    def metric(self, name: str) -> ModuleType:
        return load_module(self.pb / "metrics" / f"{name}.py")

    def kernel_classes(self) -> Dict[str, ModuleType]:
        """Every kernel class file, the program's own kernels (those with
        a SOURCE) first, so that their names win over library patterns."""
        mods = {p.stem: load_module(p)
                for p in sorted((self.pb / "kernels").glob("*.py"))}
        return dict(sorted(mods.items(),
                           key=lambda kv: (kv[1].SOURCE is None, kv[0])))

    def metrics_for(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (trace off) or per-layer metrics
        (trace on), each as the manifest states it."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.manifest[key]
                if "workloads" not in m or cell in m["workloads"]]


class Context:
    """What a kind's runner is handed."""

    def __init__(self, bench: Bench, cell: str, seed: int, seconds: float,
                 trace: bool, device, t_start: float):
        self.bench = bench
        self.cell_name = cell
        self.workload = bench.workload(cell)
        self.cell = bench.cell(cell)
        self.config = bench.config(self.workload["config"])
        self.traffic = bench.traffic(self.workload["traffic"])
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = t_start
        self.classes = bench.kernel_classes()

    def phase(self, name: str) -> None:
        """Log the set-up's host clock at the end of a phase."""
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        log(f"set-up: {name} done at "
            f"{time.perf_counter() - self.t_start:.3f} s")

    def limit(self, name: str) -> Optional[float]:
        return self.cell["limits"].get(name)


class Outcome:
    """What a runner returns."""

    def __init__(self):
        self.attempted = 0
        self.failed = 0
        self.end_to_end: Dict[str, float] = {}
        self.readings: dict = {}
        self.checks: Dict[str, tuple] = {}   # name -> (value, limit)
        self.memory_peak_bytes = 0
        self.trace = None                     # a trace.Reading
        self.device_kind = ""


def judge(outcome: Outcome) -> bool:
    if outcome.failed or not outcome.attempted:
        return False
    for value, limit in outcome.checks.values():
        if limit is None or value is None or not math.isfinite(value) \
                or value > limit:
            return False
    return bool(outcome.checks)


def result_line(bench: Bench, cell: str, trace: bool,
                outcome: Outcome) -> dict:
    metrics = {}
    for m in bench.metrics_for(cell, trace):
        if trace:
            v = bench.metric(m["name"]).read(outcome.readings)
            if v is None:
                continue
        else:
            v = outcome.end_to_end[m["name"]]
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": outcome.device_kind,
              "count": int(bench.workload(cell).get("chips", 1)),
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {"correct": judge(outcome), "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace and outcome.trace is not None:
        from portbench.harness.trace import breakdown

        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = breakdown(outcome.trace)
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in outcome.checks.items()}
    return line


def set_cache_dirs(pb: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its CUDA sources into tf_operator_tpu_torch/_build/)."""
    cache = pb / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    # a library the port might pull in must not load JAX through itself
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def run(argv=None, root: Optional[Path] = None, pb: Path = PB,
        device: Optional[str] = None, t_start: Optional[float] = None) -> int:
    """The benchmark's command line.  device=None: the card, which must be
    there; the tests pass "cpu" to drive the same run on the CPU."""
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd() if root is None else Path(root)
    set_cache_dirs(pb)
    bench = Bench(root, pb)
    chips = int(bench.workload(args.workload).get("chips", 1))

    import torch

    if device is None:
        if not torch.cuda.is_available():
            log("torch.cuda.is_available() is False: this benchmark runs on "
                "the card only")
            return 2
        if torch.cuda.device_count() < chips:
            log(f"the cell asks for {chips} cards, "
                f"{torch.cuda.device_count()} are visible")
            return 2
        device = "cuda"
    ctx = Context(bench, args.workload, args.seed, args.seconds,
                  bool(args.trace), torch.device(device), t_start)
    if ctx.device.type == "cuda":
        from portbench.harness.yardstick import device_line

        log(f"card: {device_line()}")
    outcome = bench.kind(ctx.traffic["kind"]).run(ctx)
    # the line first: its metric readers are loaded as it is built
    line = result_line(bench, args.workload, bool(args.trace), outcome)
    if outcome.trace is not None:
        t = outcome.trace
        log(f"device seconds by kernel class {t.by_class}, inside ranges "
            f"{t.by_range}; the reading's own seconds {t.seconds}")
    bad = forbidden_loaded()
    if bad:
        log(f"forbidden modules loaded in this process: {bad}")
        return 3
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
