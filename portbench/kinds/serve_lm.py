"""Runner of batch serving traffic (kind "serve_lm"): the port's
serve_loop over a Llama-family configuration, calls of the mix's
requests back to back.

Set-up builds the model from the seed's weights (int8 payloads and
scales where the configuration serves int8, handed to
Llama.from_params as models/quant.QTensor leaves) and warms up with one
short call of the mix's longest, median and shortest prompts.  The
window runs calls of `requests_per_call` requests (traffic.serve_call)
back to back and closes at the end of the first call that ends after
--seconds.  Per request, from the benchmark's own telemetry
(models/telemetry.ServeTelemetry, extended here to stamp the host
clock): TTFT = its first token - the start of its call; TPOT = (its
finish - its first token) / (its tokens - 1).

The check, once the window has closed and the program's state is
freed: a sample of the finished requests drawn from the seed, the one
with the most tokens among them, run once through the plain reference
over its prompt and served tokens; mean_gap is the mean over the served
tokens of the gap by which a token's reference logit lies below the
reference's best logit at its position (portbench/reference/serve.py).
"""
from __future__ import annotations

import gc
import time

import torch

from portbench.harness import flops, traffic, weights
from portbench.harness.core import Outcome, log
from portbench.harness.port import build_kernels, llama_config
from portbench.harness.trace import record_ranges, traced
from portbench.reference import serve as refserve

MOE_RANGE = "grouped_moe"


def _recorder():
    from tf_operator_tpu_torch.models.telemetry import ServeTelemetry

    class Recorder(ServeTelemetry):
        """ServeTelemetry that also keeps each request's host-clock time
        of its first token and of its finish."""

        def __init__(self):
            super().__init__()
            self.first, self.done = {}, {}

        def request_activated(self, index, step):
            self.first[index] = time.perf_counter()
            super().request_activated(index, step)

        def request_finished(self, index, result, step):
            self.done[index] = time.perf_counter()
            super().request_finished(index, result, step)

    return Recorder()


def _program_params(raw: dict) -> dict:
    from tf_operator_tpu_torch.models.quant import QTensor

    return {k: QTensor(*v) if isinstance(v, tuple) else v
            for k, v in raw.items()}


def _percentile(xs, q: float) -> float:
    """The q-th percentile by linear interpolation between ranks (numpy's
    default)."""
    xs = sorted(xs)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def run(ctx) -> Outcome:
    from tf_operator_tpu_torch.models.llama import Llama
    from tf_operator_tpu_torch.models.serving import serve_loop
    from tf_operator_tpu_torch.parallel import ep

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    out = Outcome()
    cuda = dev.type == "cuda"
    ctx.phase("imports")
    build_kernels(ctx)
    ctx.phase("kernels")
    shape = weights.Shape(cfg)
    int8 = cfg.get("quantization", {}).get("weights") == "int8"
    raw = (weights.draw_int8(cfg, ctx.seed, dev) if int8 else
           weights.draw_float(cfg, ctx.seed, dev,
                              getattr(torch, cfg["torch_dtype"])))
    model = Llama.from_params(llama_config(cfg, tr, train=False),
                              _program_params(raw), device=dev)
    ctx.phase("weights")
    sv = tr["serve"]
    kw = dict(slots=int(sv["slots"]), prefill_chunk=sv.get("prefill_chunk"),
              block_size=int(sv["block_size"]),
              steps_per_sync=int(sv["steps_per_sync"]),
              scheduler=sv["scheduler"], device=dev)
    prompts, budgets = traffic.warmup_call(tr, shape.vocab, ctx.seed)
    serve_loop(model, prompts, max_new_tokens=budgets, **kw)
    ctx.phase("warm-up")
    setup_s = time.perf_counter() - ctx.t_start

    steps = [0]
    hook = model.register_forward_pre_hook(
        lambda mod, args: steps.__setitem__(
            0, steps[0] + (args[0].shape[1] == 1)))
    calls = []          # (prompts, budgets, results, stats, recorder, t0)

    def window():
        t0 = time.perf_counter()
        while True:
            ps, bs = traffic.serve_call(tr, shape.vocab, ctx.seed, len(calls))
            rec = _recorder()
            tc = time.perf_counter()
            res, stats = serve_loop(model, ps, max_new_tokens=bs,
                                    return_stats=True, telemetry=rec, **kw)
            calls.append((ps, bs, res, stats, rec, tc))
            if time.perf_counter() - t0 >= ctx.seconds:
                return time.perf_counter() - t0

    undo = record_ranges([(ep, "grouped_moe", MOE_RANGE)]) if ctx.trace \
        else None
    try:
        if ctx.trace:
            window_s, out.trace = traced(
                window, {c: m.PATTERNS for c, m in ctx.classes.items()},
                ranges=(MOE_RANGE,))
        else:
            window_s = window()
    finally:
        if undo is not None:
            undo()
        hook.remove()
    if cuda:
        out.memory_peak_bytes = torch.cuda.max_memory_allocated()
        out.device_kind = torch.cuda.get_device_name(0)

    ttft, tpot, served, finished = [], [], 0, []
    for ps, bs, res, stats, rec, tc in calls:
        for i, (p, b, r) in enumerate(zip(ps, bs, res)):
            out.attempted += 1
            n = len(r.tokens)
            if n != b or i not in rec.first or i not in rec.done:
                out.failed += 1
                continue
            served += n
            ttft.append(rec.first[i] - tc)
            tpot.append((rec.done[i] - rec.first[i]) / (n - 1))
            finished.append((p, r.tokens))
    out.end_to_end = {
        "setup_s": setup_s,
        "serve_tokens_per_s": served / window_s,
        "tpot_p90_ms": 1e3 * _percentile(tpot, 90),
        "ttft_p90_s": _percentile(ttft, 90),
    }
    reqs = [(int(p.shape[0]), len(t)) for p, t in finished]
    work = dict(kind="serve_lm", shape=shape, requests=reqs,
                prefill_chunk=sv.get("prefill_chunk"))
    out.readings = dict(
        kind="serve_lm", window_s=window_s,
        model_flops=flops.serve_flops(shape, reqs), work=work,
        trace=out.trace, classes=ctx.classes, decode_steps=steps[0],
        decode_time_s=sum(c[3].decode_time_s for c in calls))
    log(f"setup_s {setup_s:.3f}; {len(calls)} calls, {out.attempted} "
        f"requests, {served} tokens in {window_s:.3f} s; "
        f"{steps[0]} decode steps")

    # the check: the program freed, the reference over a sample
    del model, calls
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    n_check = min(int(tr["check"]["requests"]), len(finished))
    g = torch.Generator().manual_seed(weights.derive(ctx.seed, "check"))
    longest = max(range(len(finished)),
                  key=lambda i: (finished[i][0].shape[0] + len(finished[i][1]),
                                 -i))
    rest = [i for i in torch.randperm(len(finished), generator=g).tolist()
            if i != longest][:n_check - 1]
    pick = [longest] + rest
    t = time.perf_counter()
    prompts = [finished[i][0].to(dev) for i in pick]
    toks = [finished[i][1] for i in pick]
    out.sample = dict(prompts=prompts, served=toks)
    gaps = refserve.gaps(refserve.logits(cfg, raw, prompts, toks), toks)
    mean_gap = sum(gaps) / len(gaps)
    log(f"reference: {len(pick)} requests, {len(gaps)} served tokens in "
        f"{time.perf_counter() - t:.3f} s; widest gap {max(gaps)!r}, "
        f"{sum(g == 0 for g in gaps)} tokens the reference's best")
    out.checks = {"mean_gap": (mean_gap, ctx.limit("mean_gap"))}
    return out
