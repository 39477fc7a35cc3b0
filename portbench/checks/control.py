"""The readings that set a cell's limits, taken on the card at the
cell's own size: its control and its faults.

    python3 portbench/checks/control.py --workload <cell> --seeds 11,12,13

Training cells, per seed: the plain reference in float32 over the run's
first steps; then, each put in the program's place and compared with it
by the cell's numbers (portbench/reference/train.numbers):
  - control: the reference with every product's operands in float8
    e4m3 (portbench/reference/precision.fp8_mm), bfloat16's next step
    down;
  - half: the reference whose loss averages over the first half of each
    row's positions only (the fault "half of the batch left out, the
    mean taken over the rest", for a batch of one row).
Serving cells, per seed: one window of the cell through the program at
its own load (one call), then over the run's sample the gaps (in the
float32 reference) of the program's served tokens, and of the tokens
the int4 reference (precision.int4_params) puts first at each of the
same positions (the control); --witness adds those of a reference whose
products round their operands to bfloat16.  Each as a profile: mean
(the compared number), share read exactly, median, 90th percentile,
widest.

Each seed prints one JSON line.  The benchmark's own runs never run
this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from portbench.harness import core, weights  # noqa: E402
from portbench.reference import precision  # noqa: E402
from portbench.reference import serve as refserve  # noqa: E402
from portbench.reference import train as reftrain  # noqa: E402


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def train_readings(ctx) -> dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    b, s_len, k = int(tr["batch"]), int(tr["seq_len"]), int(tr["check_steps"])
    vocab = weights.Shape(cfg).vocab
    gen = weights.generator(dev, ctx.seed, "tokens")
    rows = [torch.randint(0, vocab, (b, s_len), generator=gen, device=dev)
            for _ in range(k)]
    lr = float(tr["optimizer"]["learning_rate"])

    def ref_run(**kw):
        t = time.perf_counter()
        r = reftrain.run(cfg, weights.draw_float(cfg, ctx.seed, dev), rows,
                         lambda: weights.iter_float_groups(cfg, ctx.seed, dev),
                         lr, **kw)
        _free()
        r["seconds"] = time.perf_counter() - t
        return r

    base = ref_run()
    out = {"reference_losses": base["losses"], "seconds": base["seconds"]}
    for name, kw in (("control", dict(mm=precision.fp8_mm)),
                     ("half", dict(rows=slice(0, (s_len - 1) // 2)))):
        r = ref_run(**kw)
        out[name] = reftrain.numbers(r, base, k)
        out[name + "_losses"] = r["losses"]
    return out


def gap_profile(g) -> dict:
    g = sorted(g)
    n = len(g)
    return {"tokens": n, "mean": sum(g) / n,
            "zero": sum(x == 0 for x in g) / n, "p50": g[n // 2],
            "p90": g[int(0.9 * (n - 1))], "max": g[-1],
            "over_0.5": sum(x > 0.5 for x in g)}


def serve_readings(ctx, witness: bool) -> dict:
    out = ctx.bench.kind(ctx.traffic["kind"]).run(ctx)
    prompts, served = out.sample["prompts"], out.sample["served"]
    del out
    _free()
    raw = weights.draw_int8(ctx.config, ctx.seed, ctx.device)
    ref = refserve.logits(ctx.config, raw, prompts, served)
    res = {"program": gap_profile(refserve.gaps(ref, served))}
    ctl = refserve.first_choices(
        refserve.logits(ctx.config, raw, prompts, served, control=True))
    res["control"] = gap_profile(refserve.gaps(ref, ctl))
    if witness:
        def bf16_mm(a, b):
            return (a.bfloat16() @ b.bfloat16()).float()
        w = refserve.first_choices(
            refserve.logits(ctx.config, raw, prompts, served, mm=bf16_mm))
        res["bf16"] = gap_profile(refserve.gaps(ref, w))
        res["bf16_agrees_with_program"] = sum(
            a == b for x, y in zip(w, served) for a, b in zip(x, y)) / sum(
            map(len, served))
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--witness", action="store_true")
    args = ap.parse_args()
    core.set_cache_dirs(core.PB)
    bench = core.Bench(ROOT)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = core.Context(bench, args.workload, seed, 0.0, False, dev,
                           time.perf_counter())
        t = time.perf_counter()
        if ctx.traffic["kind"] == "train_lm":
            res = train_readings(ctx)
        else:
            res = serve_readings(ctx, args.witness)
        _free()
        res.update(workload=args.workload, seed=seed,
                   seconds_total=time.perf_counter() - t)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
