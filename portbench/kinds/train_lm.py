"""Runner of training traffic (kind "train_lm"): the port's training step
on a Llama-family configuration, back to back over seeded token rows.

Set-up builds one training step (train_llama.make_lm_step over
Llama.from_params with the seed's float32 masters, and
TrainState.create with the traffic's optimizer), drives it through its
first `check_steps` steps, which warm up every shape and are the steps
the check compares, and hands that same step to the window.  The
window runs steps until --seconds have passed on the host clock, then
synchronizes: train_tokens_per_s is every step's tokens over the time
from the window's start to that synchronize.

The check, once the window has closed and the program is freed: the
plain reference trains the same starting weights on the same rows for
check_steps steps, and each step's loss, each leaf's norm of the first
gradient (read from the optimizer's state after step 1, as the
optimizer got it) and each leaf's norm of the change after check_steps
steps are compared (portbench/reference/train.py).  The program-side
readings taken during set-up (the norms) are left out of setup_s.
"""
from __future__ import annotations

import gc
import math
import time

import torch

from portbench.harness import flops, weights
from portbench.harness.core import Outcome, log
from portbench.harness.port import build_kernels, llama_config
from portbench.harness.trace import traced
from portbench.reference import train as reftrain


def optimizer(spec: dict):
    from tf_operator_tpu_torch.runtime.optim import Adafactor

    if spec["name"] != "adafactor":
        raise ValueError(f"unknown optimizer {spec['name']!r}")
    return Adafactor(float(spec["learning_rate"]))


@torch.no_grad()
def first_grad_norms(state) -> dict:
    """Each leaf's norm of step 1's gradient from Adafactor's state after
    one step: at step 1 its decay is 0, so v_row (v_col) is the mean of
    g^2 + 1e-30 over the largest (second largest) dim, and v is g^2 +
    1e-30 itself."""
    from tf_operator_tpu_torch.runtime.optim import EPS, factored_dims

    st = state.opt_state
    out = {}
    for name, p in state.params.items():
        dims = factored_dims(tuple(p.shape))
        if dims is None:
            sq = float(st["v"][name].double().sum())
        else:
            sq = float(st["v_row"][name].double().sum()) * p.shape[dims[1]]
        out[name] = math.sqrt(max(sq - EPS * p.numel(), 0.0))
    return out


def run(ctx) -> Outcome:
    from tf_operator_tpu_torch.models.llama import Llama
    from tf_operator_tpu_torch.runtime.train import TrainState
    from tf_operator_tpu_torch.train_llama import make_lm_step

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    out = Outcome()
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ctx.phase("imports")
    build_kernels(ctx)
    ctx.phase("kernels")
    b, s_len, k = int(tr["batch"]), int(tr["seq_len"]), int(tr["check_steps"])
    shape = weights.Shape(cfg)
    lcfg = llama_config(cfg, tr, train=True)

    model = Llama.from_params(lcfg, weights.draw_float(cfg, ctx.seed, dev),
                              device=dev, train=True)
    state = TrainState.create(model, optimizer(tr["optimizer"]))
    step = make_lm_step(model)
    ctx.phase("weights and optimizer state")
    gen = weights.generator(dev, ctx.seed, "tokens")

    def batch():
        return torch.randint(0, shape.vocab, (b, s_len), generator=gen,
                             device=dev)

    # set-up: the first steps, which the check compares
    rows, losses, check_s = [], [], 0.0
    for i in range(k):
        tokens = batch()
        rows.append(tokens)
        state, m = step(state, tokens)
        losses.append(m["loss"])
        if i == 0:
            t = time.perf_counter()
            grad_norms = first_grad_norms(state)
            check_s += time.perf_counter() - t
    t = time.perf_counter()
    prog = dict(losses=[float(x) for x in losses], grad_norms=grad_norms,
                change_norms=reftrain.change_norms(
                    {n: p.detach() for n, p in state.params.items()},
                    weights.iter_float_groups(cfg, ctx.seed, dev)))
    sync()
    check_s += time.perf_counter() - t
    ctx.phase("first steps")
    setup_s = time.perf_counter() - ctx.t_start - check_s

    def window():
        n, w_losses = 0, []
        t0 = time.perf_counter()
        st = state
        while True:
            st, m = step(st, batch())
            w_losses.append(m["loss"])
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        sync()
        return n, w_losses, time.perf_counter() - t0

    if ctx.trace:
        (steps, w_losses, window_s), out.trace = traced(
            window, {c: m.PATTERNS for c, m in ctx.classes.items()})
    else:
        steps, w_losses, window_s = window()
    if cuda:
        out.memory_peak_bytes = torch.cuda.max_memory_allocated()
        out.device_kind = torch.cuda.get_device_name(0)
    w_losses = [float(x) for x in w_losses]
    out.attempted = steps
    out.failed = sum(1 for x in w_losses if not math.isfinite(x))
    out.end_to_end = {"setup_s": setup_s,
                      "train_tokens_per_s": steps * b * s_len / window_s}
    work = dict(kind="train_lm", shape=shape, batch=b, seq_len=s_len,
                steps=steps, attention=tr.get("attention"))
    out.readings = dict(kind="train_lm", window_s=window_s,
                        model_flops=steps * flops.train_flops(shape, b, s_len),
                        work=work, trace=out.trace, classes=ctx.classes)
    log(f"setup_s {setup_s:.3f} (check readings {check_s:.3f} s left out); "
        f"{steps} steps in {window_s:.3f} s; set-up losses "
        f"{prog['losses']}; window losses {w_losses}")

    # the check: the program freed, the reference on the same inputs
    del model, state, step, m, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    refr = reftrain.run(
        cfg, weights.draw_float(cfg, ctx.seed, dev),
        rows,
        lambda: weights.iter_float_groups(cfg, ctx.seed, dev),
        float(tr["optimizer"]["learning_rate"]))
    nums = reftrain.numbers(prog, refr, k)
    n_leaves = len(refr["grad_norms"])
    log(f"reference: {k} steps in {time.perf_counter() - t:.3f} s, losses "
        f"{refr['losses']}; {n_leaves - len(reftrain.moved(refr))} of "
        f"{n_leaves} leaves left out of change_gap")
    out.checks = {name: (v, ctx.limit(name)) for name, v in nums.items()}
    return out
