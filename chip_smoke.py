"""GPU smoke run of the PyTorch/CUDA port (tf_operator_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` (on PATH or under CUDA_HOME, default
/usr/local/cuda) and the repository checkout around this file.  Exits
non-zero, printing no result, when there is no card or no checkout.
Phases, in order, none of them caught:

  1. device:  the card's name and power limit (nvidia-smi), torch/CUDA.
  2. build:   nvcc builds every kernel of the port from csrc/.
  3. kernel:  the paged-attention kernel (csrc/paged_attention.cu) against
              its plain PyTorch version on the card at the serving shapes
              of llama3_8b (H=32, KV=8, D=128, bs=16, 8 lanes up to ~1k
              positions, scratch padding, a frozen lane, a modular ring
              table), L=1 and L=512, bf16 and f32, with and without a
              window; then its time beside the plain version's, an SDPA
              yardstick and the card's bound.
  4. serve:   llama3_8b at full width and depth (bf16, random weights from
              a seed) serves 16 requests through serve_loop on a paged
              pool; every KV read goes through the kernel, whose launch
              count must equal layers x model calls.
  5. parity:  full width, 2 layers, f32 (TF32 off): serve_loop's greedy
              tokens on the card (kernel) equal those on the CPU (plain).

Prints the kernel table as one JSON line, then the device line, and last
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

instead builds the kernels and prints where serving time goes at full
width (device time by kernel under torch.profiler, and the device's idle
share) for one decode block and one prefill segment.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.float32: 67e12}     # f32 outside the tensor cores
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ device
def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------------- build
def build() -> None:
    from tf_operator_tpu_torch import kernels

    t0 = time.perf_counter()
    per_source = kernels.build_all()
    log(f"[build] {len(per_source)} kernel source(s) built in "
        f"{time.perf_counter() - t0:.2f} s: "
        + json.dumps({k: round(v, 2) for k, v in per_source.items()}))
    for name, out in kernels.build_logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# ------------------------------------------------------------ kernel phase
B, H, KV, D, BS = 8, 32, 8, 128, 16
MAX_CTX, MAX_NEW = 1024, 64


def make_case(dtype, l: int, window, ring: bool, seed: int, bs: int = BS):
    """Pools, tables, positions and q for one kernel case.  Lanes 0..6
    are live at ragged positions; lane 7 is frozen (all-scratch table).
    The scratch block is poisoned, so a masking fault shows.  ring=True
    gives every live lane a full modular table with positions past
    T*bs (the sliding-window table discipline)."""
    from tf_operator_tpu_torch.models.paging import blocks_for

    g = torch.Generator(device="cpu").manual_seed(seed)
    dev = torch.device("cuda")
    n_slots = blocks_for(MAX_CTX + MAX_NEW, bs)
    if ring:
        ctx = [int(c) for c in torch.randint(
            n_slots * bs + l, 2 * n_slots * bs, (B - 1,), generator=g)]
        need = [n_slots] * (B - 1)
    else:
        ctx = [int(c) for c in torch.randint(
            max(l, 8) + 8, MAX_CTX + 1, (B - 1,), generator=g)]
        ctx[0] = MAX_CTX  # the longest lane sits at the serve phase's cap
        need = [blocks_for(c, bs) for c in ctx]
    n_blocks = sum(need)
    ids = (torch.randperm(n_blocks, generator=g) + 1).tolist()
    table = torch.zeros((B, n_slots), dtype=torch.int32)
    at = 0
    for b, n in enumerate(need):
        table[b, :n] = torch.tensor(ids[at:at + n], dtype=torch.int32)
        at += n
    pos = torch.tensor([c - l for c in ctx] + [0], dtype=torch.int32)
    shape = (n_blocks + 1, bs, KV, D)
    k_pool = torch.randn(shape, generator=g)
    v_pool = torch.randn(shape, generator=g)
    k_pool[0] = 1e4
    v_pool[0] = 1e4
    q = torch.randn((B, l, H, D), generator=g)
    return dict(q=q.to(dev, dtype), k=k_pool.to(dev, dtype),
                v=v_pool.to(dev, dtype), table=table.to(dev),
                pos=pos.to(dev), window=window, ctx=ctx)


def bound_ms(case, dtype) -> tuple:
    """The least time the card could take for a full-causal linear-table
    case: the larger of the bytes the function must move over HBM
    bandwidth and its operations over the dtype's peak.  Bytes: each
    visible K/V block read once (a lane at ctx positions sees
    ceil(ctx / bs) blocks), q, out, the tables and positions.
    Operations: QK^T and PV of every query row against the positions
    visible to it (2 flops per multiply-add)."""
    from tf_operator_tpu_torch.models.paging import blocks_for

    esz = torch.finfo(dtype).bits // 8
    q = case["q"]
    b, l, h, d = q.shape
    kv_bytes = sum(blocks_for(c, BS) for c in case["ctx"]) * BS * KV * D \
        * esz * 2
    io = 2 * q.numel() * esz + case["table"].numel() * 4 + b * 4
    flops = 0
    for c in case["ctx"]:
        # row i of L sees c - L + 1 + i positions
        flops += 2 * 2 * h * d * (l * (c - l + 1) + l * (l - 1) // 2)
    t_bytes = (kv_bytes + io) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps launches, each after an L2
    flush (the serving caller finds the pool cold: 31 other layers'
    weights pass through L2 between two reads of one layer's pool)."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def sdpa_inputs(case):
    """The gathered linear view and mask that torch's
    scaled_dot_product_attention takes for the same function (the
    yardstick only: the port never calls SDPA)."""
    from tf_operator_tpu_torch.models import paging

    q = case["q"]
    k = paging.gather_blocks(case["k"], case["table"]).transpose(1, 2)
    v = paging.gather_blocks(case["v"], case["table"]).transpose(1, 2)
    c = k.shape[2]
    l = q.shape[1]
    qp = case["pos"].long()[:, None] + torch.arange(l, device=q.device)
    slot = torch.arange(c, device=q.device)
    kg = qp[..., None] - torch.remainder(qp[..., None] - slot, c)
    mask = kg >= 0
    if case["window"] is not None:
        mask &= kg > qp[..., None] - case["window"]
    return q.transpose(1, 2), k, v, mask[:, None]


def kernel_phase() -> dict:
    from tf_operator_tpu_torch.models import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # f32: the kernel folds 16-position blocks by online softmax, the
    # plain version takes one softmax, so sums run in another order
    # (~1e-6 on O(1) outputs).  bf16: both round p to bf16, but at
    # different maxima (running vs final), and round the output to bf16
    # (2^-8 relative).
    tol = {torch.float32: (5e-5, 5e-5), torch.bfloat16: (2e-2, 2e-2)}
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(dt, l, w, False, BS)
             for dt in (torch.bfloat16, torch.float32)
             for l in (1, 512) for w in (None, 256)]
    cases += [(dt, 1, 512, True, BS)
              for dt in (torch.bfloat16, torch.float32)]
    # serve_loop's default block size, 64: past 48 KB of shared memory
    cases += [(dt, 1, None, False, 64) for dt in (torch.bfloat16,
                                                  torch.float32)]
    for i, (dt, l, w, ring, bs) in enumerate(cases):
        case = make_case(dt, l, w, ring, SEED + i, bs)
        args = (case["q"], case["k"], case["v"], case["table"], case["pos"])
        got = pa.paged_attention(*args, window=w)
        ref = pa.paged_attention_plain(*args, window=w)
        torch.cuda.synchronize()
        live = slice(0, B - 1)
        diff = (got[live].float() - ref[live].float()).abs()
        atol, rtol = tol[dt]
        ok = bool((diff <= atol + rtol * ref[live].float().abs()).all())
        frozen_zero = bool((got[B - 1] == 0).all())
        err = float(diff.max())
        errs[dt] = max(errs[dt], err)
        log(f"[kernel] {str(dt)[6:]:8s} L={l:<4d} bs={bs} window={w} "
            f"ring={ring} "
            f"max_abs_err={err:.3e} (atol {atol}, rtol {rtol}) "
            f"frozen_lane_zero={frozen_zero}")
        if not (ok and frozen_zero and torch.isfinite(got).all()):
            raise AssertionError(
                f"paged_attention kernel disagrees with its plain version: "
                f"dtype={dt} L={l} bs={bs} window={w} ring={ring} "
                f"err={err}")

    timings = {}
    for name, l in (("decode", 1), ("prefill", 512)):
        case = make_case(torch.bfloat16, l, None, False, SEED + 100)
        args = (case["q"], case["k"], case["v"], case["table"], case["pos"])
        sq, sk, sv, mask = sdpa_inputs(case)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # plain, kernel, kernel, plain: one card, in turns
        p1 = time_ms(lambda: pa.paged_attention_plain(*args))
        k1 = time_ms(lambda: pa.paged_attention(*args))
        k2 = time_ms(lambda: pa.paged_attention(*args))
        p2 = time_ms(lambda: pa.paged_attention_plain(*args))
        lib = time_ms(lambda: sdpa(sq, sk, sv, attn_mask=mask,
                                   enable_gqa=True))
        bnd, by = bound_ms(case, torch.bfloat16)
        timings[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                             library_ms=lib, bound_ms=bnd, bound_by=by)
        log(f"[kernel] timing {name} bf16 B={B} L={l} H={H} KV={KV} D={D} "
            f"bs={BS} ctx={case['ctx']}: kernel {k1:.4f}/{k2:.4f} ms, "
            f"plain {p1:.4f}/{p2:.4f} ms, sdpa {lib:.4f} ms, "
            f"bound {bnd:.4f} ms ({by})")
    return dict(errs=errs, timings=timings)


# ------------------------------------------------------------- serve phase
def prompts_for(cfg, n: int, lo: int, hi: int, seed: int):
    g = torch.Generator(device="cpu").manual_seed(seed)
    lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
    return [torch.randint(0, cfg.vocab_size, (m,), generator=g)
            for m in lens]


def serve_phase() -> dict:
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop

    cfg = llama.llama3_8b()
    t0 = time.perf_counter()
    model = llama.Llama.from_params(
        cfg, bridge.init_params(cfg, SEED, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] llama3_8b {cfg.n_layers} layers d_model={cfg.d_model} "
        f"vocab={cfg.vocab_size} {cfg.dtype}: random weights in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    kw = dict(slots=8, block_size=BS, steps_per_sync=8, device="cuda")
    prompts = prompts_for(cfg, 16, 64, MAX_CTX, SEED + 1)
    # warm-up (cuBLAS handles, allocator) on two short requests
    serve_loop(model, [p[:64] for p in prompts[:2]], max_new_tokens=8, **kw)
    torch.cuda.synchronize()

    calls = [0]
    hook = model.register_forward_hook(
        lambda *_: calls.__setitem__(0, calls[0] + 1))
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launches()
    results, stats = serve_loop(model, prompts, max_new_tokens=MAX_NEW,
                                return_stats=True, **kw)
    torch.cuda.synchronize()
    launches = pa.launches
    hook.remove()
    peak = torch.cuda.max_memory_allocated()

    for i, r in enumerate(results):
        if len(r.tokens) != MAX_NEW:
            raise AssertionError(f"request {i} emitted {len(r.tokens)} "
                                 f"tokens, budget {MAX_NEW}")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {i}: token out of vocab")
    if launches != cfg.n_layers * calls[0] or launches == 0:
        raise AssertionError(
            f"paged_attention launched {launches} times for {calls[0]} "
            f"model calls x {cfg.n_layers} layers")
    ttft = sorted(r["ttft_s"] for r in stats.per_request)
    pct = lambda p: ttft[min(len(ttft) - 1, math.ceil(p * len(ttft)) - 1)]
    e2e = [r["e2e_latency_s"] for r in stats.per_request]
    log(f"[serve] {len(results)} requests, prompts "
        f"{[int(p.shape[0]) for p in prompts]}, {MAX_NEW} new tokens each")
    log(f"[serve] tokens={stats.total_tokens} wall_s={stats.wall_time_s:.4f} "
        f"tokens_per_s={stats.tokens_per_sec:.2f} "
        f"ttft_p50_s={pct(0.5):.4f} ttft_p99_s={pct(0.99):.4f} "
        f"e2e_max_s={max(e2e):.4f} prefill_s={stats.prefill_time_s:.4f} "
        f"decode_s={stats.decode_time_s:.4f} model_calls={calls[0]} "
        f"kernel_launches={launches} "
        f"max_memory_allocated_gib={peak / 2**30:.3f}")
    del model
    torch.cuda.empty_cache()
    return dict(launches=launches)


# ------------------------------------------------------------ parity phase
def parity_phase() -> None:
    from tf_operator_tpu_torch.models import bridge, llama, paging
    from tf_operator_tpu_torch.models.serving import serve_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama.llama3_8b(n_layers=2, dtype=torch.float32)
    params = bridge.init_params(cfg, SEED + 2, device="cuda")
    m_gpu = llama.Llama.from_params(cfg, params, device="cuda")
    m_cpu = llama.Llama.from_params(
        cfg, {k: v.cpu() for k, v in params.items()}, device="cpu")
    del params
    prompts = prompts_for(cfg, 4, 24, 96, SEED + 3)
    kw = dict(slots=2, max_new_tokens=16, block_size=BS, steps_per_sync=8)
    got = serve_loop(m_gpu, prompts, device="cuda", **kw)
    want = serve_loop(m_cpu, prompts, device="cpu", **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        log(f"[parity] request {i}: cuda {g.tokens}")
        if g.tokens != w.tokens:
            raise AssertionError(
                f"[parity] request {i}: cuda tokens {g.tokens} != cpu "
                f"tokens {w.tokens}")
    # logits of one prefill on both devices: finite, same shape, close
    # (f32, TF32 off; only the summation order differs)
    tok = prompts[0][None, :32]
    out = []
    for m, dev in ((m_gpu, "cuda"), (m_cpu, "cpu")):
        cache = paging.init_block_pool(cfg, 2, BS, device=dev)
        table = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
        with torch.inference_mode():
            out.append(m(tok.to(dev), cache, 0, table).float().cpu())
    diff = float((out[0] - out[1]).abs().max())
    log(f"[parity] {len(prompts)} requests x 16 greedy tokens identical "
        f"on cuda and cpu; prefill logits {tuple(out[0].shape)} "
        f"max_abs_diff={diff:.3e} (atol 1e-3)")
    if not (torch.isfinite(out[0]).all() and diff <= 1e-3):
        raise AssertionError(f"[parity] logits differ by {diff}")


# ----------------------------------------------------------- profile phase
def _kernel_class(name: str) -> str:
    if "paged_attention" in name:
        return "paged_attention (K1)"
    if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    return "other"


def _profile(fn, label: str, steps: int) -> None:
    """Device time of fn() by kernel under torch.profiler, per step, and
    the device's idle share of the host-clock window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, by_class = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        cls = _kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    # the profiler slows the host side, not the kernels: the idle share
    # of an unprofiled step is its host-clock time less the device time
    log(f"[profile] {label}: {wall_ms / steps:.4f} ms per step (host clock, "
        f"no profiler); device busy {busy_ms / steps:.4f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.4f} (under the profiler "
        f"{prof_wall_ms / steps:.4f} ms, idle {1 - busy_ms / prof_wall_ms:.4f})")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"[profile] {label}:   {cls:22s} {us / 1e3 / steps:9.4f} ms "
            f"per step, {us / 1e3 / busy_ms:.4f} of device time")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile] {label}:     {us / 1e3 / steps:9.4f} ms  {name[:90]}")


def profile_phase() -> None:
    """Where serving time goes at full width: one 8-step decode block of
    llama3_8b for 8 lanes at 512 positions each, and one 512-token
    prefill segment, each under torch.profiler."""
    from tf_operator_tpu_torch.models import bridge, llama, paging, serving

    cfg = llama.llama3_8b()
    model = llama.Llama.from_params(
        cfg, bridge.init_params(cfg, SEED, device="cuda"), device="cuda")
    lanes, ctx, steps = 8, 512, 8
    per_lane = paging.blocks_for(ctx + steps, BS)
    cache = paging.init_block_pool(cfg, lanes * per_lane, BS, device="cuda")
    table = (torch.arange(lanes * per_lane, dtype=torch.int32,
                          device="cuda").view(lanes, per_lane) + 1)
    tok = torch.randint(0, cfg.vocab_size, (lanes,), device="cuda")
    pos = torch.full((lanes,), ctx, dtype=torch.int32, device="cuda")
    frozen = torch.zeros(lanes, dtype=torch.bool, device="cuda")
    greedy = lambda logits: torch.argmax(logits, dim=-1)
    segment = torch.randint(0, cfg.vocab_size, (1, ctx), device="cuda")
    with torch.inference_mode():
        _profile(lambda: serving.decode_block(model, cache, tok, pos, frozen,
                                              table, steps, greedy),
                 f"decode {lanes} lanes x ctx {ctx}", steps)
        _profile(lambda: serving.chunk_fill(model, cache, segment, 0,
                                            table[:1]),
                 f"prefill 1 lane x {ctx} tokens", 1)


# -------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import tf_operator_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = device_line()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    build()
    if sys.argv[1:] == ["--profile"]:
        profile_phase()
        return 0
    kern = kernel_phase()
    serve = serve_phase()
    parity_phase()

    t = kern["timings"]["decode"]
    row = {"name": "paged_attention", "route": "cuda",
           "source": "tf_operator_tpu_torch/csrc/paged_attention.cu",
           "replaces": "tf_operator_tpu/models/paged_attention.py:96",
           "launches": serve["launches"],
           "max_abs_err": kern["errs"][torch.bfloat16],
           "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
           "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
           "library_ms": t["library_ms"]}
    print(json.dumps({"kernels": [row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
