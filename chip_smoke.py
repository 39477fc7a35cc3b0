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
              table), L=1 and L=512, bf16 (the tensor-core design, split
              over the table at decode) and f32 (the scalar design), with
              and without a window; the split's edges (contexts ending
              inside the first chunk, on chunk boundaries and inside
              chunks, a window that empties whole chunks, L*G = 12, 16 and
              17 rows), L=974 and bs=64, the spec phase's verify (8 lanes
              at L=5, each at its own position, 20 rows a kv head) and
              draft step (L=1) over 69-slot tables with lanes across,
              on and off block edges; two launches give the same bits;
              then its time beside the plain version's, an SDPA yardstick
              and the card's bound, and the kernel's and SDPA's device
              time alone, at decode, prefill and the verify.
  4. serve:   llama3_8b at full width and depth (bf16, random weights from
              a seed) serves 16 requests through serve_loop on a paged
              pool; every KV read goes through the kernel, whose launch
              count must equal layers x model calls, every one of them
              through the tensor-core design.  Its telemetry: a private
              Tracer holds one span tree a request (queued, prefill,
              decode), whose Chrome export parses; the card's memory
              peak is reported; TPOT, end-to-end latency and occupancy
              are printed (as in every serving phase).
  4b. spec:   the serve phase's model and prompts served speculatively,
              64 new tokens, 8 slots, spec_k 4, 4 rounds a block, the
              draft the target's own first 8 layers: (a) the slot
              scheduler, (b) the continuous one, which gives (a)'s
              tokens; then the target as its own draft (8 requests),
              whose acceptance rate must pass 0.9.  K1 launches equal
              target layers x target calls + draft layers x draft calls,
              all on the tensor cores.
  4c. dense:  the serve phase's model and prompts over dense per-lane
              rings, serve_loop(paged=False): (a) the slot scheduler, (b)
              the continuous one, which gives (a)'s tokens (how many
              requests give the serve phase's paged tokens is printed);
              generate on 8 equal 512-token prompts, one pass and in
              chunks of 128; the self-draft witnesses over the spec
              phase's witness requests, serve_loop and
              speculative_generate, each accepting more than 0.9; the
              rings' bytes beside the paged pool's.  No kernel reads a
              dense ring: K1 and K1q launch 0 times.
  5. handoff: the serve phase's model over one shared 1000-token prefix
              (62 whole blocks of 16 and a copy-on-write boundary block)
              and 16 suffixes of 32-256 tokens, 64 new tokens each, 8
              slots: (a) unified serve_loop(shared_prefix=), (b)
              prefill_only=True, (c) serve_loop(full prompts, adopt=(b)'s
              handoffs) under the slot scheduler, (d) the same under the
              continuous one; (c) and (d) give (a)'s tokens, CoW and
              prefix reuse happen, the first export carries the 62
              prefix payloads and no later one does, exports and
              adoptions are counted, K1 launches equal layers x model
              calls in every run, all on the tensor cores; then
              export_blocks and adopt_blocks timed alone for one 79-block
              lane (seconds, GB/s, the hashing's share).
  6. parity:  full width, 2 layers, f32 (TF32 off): serve_loop's greedy
              tokens on the card (kernel) equal those on the CPU (plain);
              then the handoff with int8 KV (K1q) over an unaligned
              prefix, exported on the card and adopted on the card and
              on the CPU under both schedulers, gives the CPU's unified
              tokens.
  6b. spec-parity: full width, 2 layers, f32 (TF32 off), a 1-layer draft
              from another seed, spec_k 3: tokens, schedule and each
              request's accepted/proposed drafts on the card equal the
              CPU's under both schedulers, over an unaligned prefix, with
              the target as its own draft (rounds that accept), and with
              int8 weights, KV and draft (K1q, over the parity-int8
              phase's first two requests); the card's speculative tokens
              equal its non-speculative ones.  Then, informational, how
              far int8 KV moves one prefill's logits between the card and
              the CPU.
  6c. dense-parity: full width, 2 layers, f32 (TF32 off): generate one
              pass and chunked, speculative_generate self-drafted and
              over a windowed ring the verify wraps (window 32, 40
              slots; = generate on the card), serve_loop(paged=False)
              under both schedulers, over an unaligned prefix, with a
              1-layer draft, and with int8 weights and KV over the
              spec-parity phase's int8 requests: tokens (and schedules)
              on the card equal the CPU's; dense = paged on the card.
  7. window:  mistral_7b at full width and depth (bf16, random weights
              from seed 0, sliding window 4096) over a 1024-token shared
              prefix and 16 suffixes of 1024-6656 tokens, 128 new tokens
              each, 8 slots, prefill_chunk 512: a modular ring of 288
              slots of 16 (4608 positions) per lane, through which the
              long prompts stream and onto whose prefix slots the rings
              wrap; (a) the slot scheduler, (b) the continuous one, (c)
              the first 8 requests as prefill_only, adopted under the
              continuous scheduler.  (b) and (c) give (a)'s tokens, every
              run evicts ring blocks and swaps prefix slots for shadows,
              each leaves the pool holding the prefix's blocks alone, K1
              launches equal layers x model calls, all on the tensor
              cores, and K1q is never launched.
  8. window-parity: mistral_7b at full width, 2 layers, f32 (TF32 off),
              window 64 and max_len 512 (a 128-position ring): prompts
              streaming past the ring over a shared prefix, under both
              schedulers, give the CPU's tokens and schedule; so do an
              unaligned prefix at window 120, unchunked (the rotation
              copies prefix blocks, the boundary is copied on write), and
              int8 KV (K1q); an int8-KV windowed handoff exported on the
              card and adopted on the card and on the CPU gives the CPU's
              unified tokens.  Then K1 and K1q at the window phase's
              shapes (8 lanes at L=1 over wrapped 288-slot rings, one
              lane's L=512 segment past the ring, window 4096) against
              their plain versions, timed beside them, SDPA with the
              window mask and the bound counting only the window's keys.
  9. kernel2: the flash-attention kernels (csrc/flash_attention.cu: K2f
              forward, K2q dQ, K2kv dK/dV) against their plain versions at
              the llama3_8b training shapes (B=1, S=2048, H=32, KV=8,
              D=128), bf16 (all three on the tensor cores) and f32:
              causal, non-causal, window 512, and S=1000 (no 128-aligned
              tiling); then at D=64: S=1000, S=64, window 512 and
              non-causal; at D=128: S=129 and S=192 non-causal; two
              launches give the same bits; then each kernel's time beside
              its plain version, SDPA and the card's bound, and each
              kernel's and SDPA's device time alone.
 10. train:   llama3_8b at full width and depth as train_llama builds it
              (tied embeddings, remat, flash attention, blocked CE,
              adafactor), f32 master weights from a seed, bf16 compute,
              batch 1 x 2048 (train_llama's 8 x 8192 cut to fit one card),
              4 steps through run_training; every loss finite, the first
              near ln(vocab); K2f launched 2 x 32 times a step (forward and
              remat recompute), K2q and K2kv 32 times, every launch on the
              tensor cores.
 11. train-parity: full width, 2 layers, f32 (TF32 off), batch 2 x 128:
              the loss and every parameter's gradient norm of one step on
              the card (kernels) equal those on the CPU (plain versions).
 12. kernel1q: the int8 paged-attention kernel (K1q, the same source)
              against its plain version on the kernel phase's cases, with
              int8 pools quantized from them and the scratch block
              poisoned (payload 127, scale 1e4); two launches give the
              same bits; then its time beside the plain version's, an SDPA
              yardstick over the gathered dequantized view and the bound.
 13. serve-int8: llama3_8b at full width and depth with int8 weights
              (quantized from the seeded f32 draws) and int8 KV serves the
              serve phase's 16 requests under scheduler="continuous",
              prefill_chunk=256 streamed one segment per turn, on a pool
              of 240 blocks (the slot loop's default is 520): the step
              gate blocks, lanes are preempted, prompt segments ride the
              decode dispatches; every read goes through K1q, whose launch
              count must equal layers x model calls, every one of them
              through the tensor-core design, and none through K1.
 14. parity-int8: full width, 2 layers, f32 (TF32 off), int8 weights and
              KV, prefill_chunk set: greedy tokens and schedule of the
              continuous scheduler on the card equal those on the CPU,
              and the card's continuous tokens equal its slot tokens.
 15. kernel3: the ring flash attention step kernels (csrc/ring_flash.cu:
              K3f forward step, K3q dQ, K3kv dK/dV) against their plain
              versions at the ring-train shapes (B=1, S_l=512, H=32, KV=8,
              D=128, a ring of 4), bf16 and f32: a diagonal, a past and a
              future step, zigzag offsets, window 512, a carry-in with rows
              that saw no key, and S_l=200 (tiles straddle the zigzag
              halves), the backward's lse as the forward leaves it; two
              launches give the same bits, a dead step leaves every
              accumulator as it was, and every bf16 K3q and K3kv launch
              runs on the tensor cores; then the time of
              the last member's launches over its ring beside the plain
              versions, the bound and SDPA of that member's q against the
              whole sequence, and their device time alone.
 16. ring-train: the train phase's model, tokens and recipe with
              attention_fn = ring flash attention over LocalRing(4)
              (contiguous, batch 1 x 2048, S_l = 512), 4 steps: every loss
              finite, the first equal to the train phase's; K2 launched
              never, K3f/K3q/K3kv exactly as the ring schedule's live
              (member, step) pairs say (K3f twice: forward and remat),
              every K3q and K3kv launch on the tensor cores.
 17. ring-parity: full width, 2 layers, f32 (TF32 off), batch 1 x 256,
              LocalRing(4), zigzag with positions: the loss and every
              gradient norm equal across the ring on the card (K3), the
              ring on the CPU (plain versions) and the one-device flash
              attention on the card (K2).
 18. entry:   train_llama.main(["--smoke", "--ring", "--steps", "2"]) on the
              card: its ring of one member launches K3 (bf16 compute
              at D = 16: K3q and K3kv on the tensor cores).

Prints the kernel table as one JSON line, then the device line, and last
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

instead builds the kernels and prints where the time goes at full width
(device time by kernel under torch.profiler, and the device's idle share)
for one decode block and one prefill segment (bf16, then int8 weights and
KV), one training step and one ring training step.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
            # ptxas names each kernel (mangled) before its report
            if any(k in line for k in ("Function properties for",
                                       "registers", "spill")):
                log(f"[build] {name}: {line.strip()}")


# ------------------------------------------------------------ kernel phase
B, H, KV, D, BS = 8, 32, 8, 128, 16
MAX_CTX, MAX_NEW = 1024, 64


def make_case(dtype, l: int, window, ring: bool, seed: int, bs: int = BS,
              ctx=None, h: int = H, t_slots=None):
    """Pools, tables, positions and q for one kernel case.  Lanes 0..6
    are live at ragged positions (or at the contexts `ctx` gives); lane 7
    is frozen (all-scratch table).  The scratch block is poisoned, so a
    masking fault shows.  ring=True gives every live lane a full modular
    table with positions past T*bs (the sliding-window table
    discipline).  h: query heads over the KV = 8 kv heads.  t_slots: the
    table's width (default: the serve phase's, MAX_CTX + MAX_NEW)."""
    from tf_operator_tpu_torch.models.paging import blocks_for

    g = torch.Generator(device="cpu").manual_seed(seed)
    dev = torch.device("cuda")
    n_slots = t_slots or blocks_for(MAX_CTX + MAX_NEW, bs)
    if ring:
        ctx = [int(c) for c in torch.randint(
            n_slots * bs + l, 2 * n_slots * bs, (B - 1,), generator=g)]
        need = [n_slots] * (B - 1)
    else:
        if ctx is None:
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
    q = torch.randn((B, l, h, D), generator=g)
    return dict(q=q.to(dev, dtype), k=k_pool.to(dev, dtype),
                v=v_pool.to(dev, dtype), table=table.to(dev),
                pos=pos.to(dev), window=window, ctx=ctx)


def bound_ms(case, dtype, int8: bool = False) -> tuple:
    """The least time the card could take for a full-causal linear-table
    case: the larger of the bytes the function must move over HBM
    bandwidth and its operations over the dtype's peak.  Bytes: each
    visible K/V block read once (a lane at ctx positions sees
    ceil(ctx / bs) blocks; int8 pools: one byte an element plus the f32
    scale of each (position, head)), q, out, the tables and positions.
    Operations: QK^T and PV of every query row against the positions
    visible to it (2 flops per multiply-add)."""
    from tf_operator_tpu_torch.models.paging import blocks_for

    esz = torch.finfo(dtype).bits // 8
    q = case["q"]
    b, l, h, d = q.shape
    per_pos = KV * D * esz if not int8 else KV * D + KV * 4
    kv_bytes = sum(blocks_for(c, BS) for c in case["ctx"]) * BS * per_pos * 2
    io = 2 * q.numel() * esz + case["table"].numel() * 4 + b * 4
    flops = 0
    for c in case["ctx"]:
        # row i of L sees c - L + 1 + i positions
        flops += 2 * 2 * h * d * (l * (c - l + 1) + l * (l - 1) // 2)
    t_bytes = (kv_bytes + io) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 20, queued: bool = False) -> float:
    """Mean time of fn() over reps launches between two CUDA events, each
    after an L2 flush (the serving caller finds the pool cold: 31 other
    layers' weights pass through L2 between two reads of one layer's
    pool).  The events bracket the host's call too, so a wrapper's Python
    time counts where the card would wait for it.  queued=True first
    holds the card (torch.cuda._sleep, 1e6 cycles: about half a
    millisecond), so the call is enqueued before the start event fires
    and only device time is read.  Whether the hold covered the host's
    enqueue is checked on every launch: if the start event has already
    fired when the host is done, the card waited for the host, and the
    launch is taken again with the hold doubled (a ring member's four
    wrapper calls and SDPA's autograd backward are the longest enqueues
    timed here)."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total, done, hold = 0.0, 0, 1_000_000
    while done < reps:
        flush.zero_()
        if queued:
            torch.cuda._sleep(hold)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        late = queued and start.query()
        torch.cuda.synchronize()
        if late:
            if hold >= 2 ** 26:
                raise RuntimeError("a hold of 2^26 cycles did not cover "
                                   "the host's enqueue")
            hold *= 2
            log(f"[time] the hold did not cover the enqueue: now {hold} "
                f"cycles")
            continue
        total += start.elapsed_time(end)
        done += 1
    return total / reps


def sdpa_inputs(case):
    """The gathered linear view (int8 pools: dequantized to q's dtype)
    and mask that torch's scaled_dot_product_attention takes for the
    same function (the yardstick only: the port never calls SDPA)."""
    from tf_operator_tpu_torch.models import paging
    from tf_operator_tpu_torch.models.quant import QTensor

    q = case["q"]

    def view(pool):
        g = paging.gather_blocks(pool, case["table"])
        return g.dequantize(q.dtype) if isinstance(g, QTensor) else g

    k = view(case["k"]).transpose(1, 2)
    v = view(case["v"]).transpose(1, 2)
    c = k.shape[2]
    l = q.shape[1]
    qp = case["pos"].long()[:, None] + torch.arange(l, device=q.device)
    slot = torch.arange(c, device=q.device)
    kg = qp[..., None] - torch.remainder(qp[..., None] - slot, c)
    mask = kg >= 0
    if case["window"] is not None:
        mask &= kg > qp[..., None] - case["window"]
    return q.transpose(1, 2), k, v, mask[:, None]


# f32: the kernel folds 16-position blocks by online softmax, the plain
# version takes one softmax, so sums run in another order (~1e-6 on O(1)
# outputs).  bf16: both round p to bf16, but at different maxima (running
# vs final), and round the output to bf16 (2^-8 relative).  K1q holds the
# same: kernel and plain version read the same dequantized values.
PAGED_TOL = {torch.float32: (5e-5, 5e-5), torch.bfloat16: (2e-2, 2e-2)}


# the handoff phase's shapes: a 1000-token shared prefix, suffixes of up
# to 256 tokens and 64 new tokens, over tables of blocks_for(1320, 16) = 83
# slots.  Its prefix write is L=1000 at position 0, its longest suffix
# fill L=256 at position 1000, and its decode runs 8 lanes at contexts of
# 1033 to 1320 (1024, 1152 and 1280 end on the split's chunk edges)
PREFIX_LEN, SUFFIX_MAX = 1000, 256
HANDOFF_CTX = [1320, 1033, 1024, 1152, 1256, 1280, 1001]


def handoff_t_slots() -> int:
    from tf_operator_tpu_torch.models.paging import blocks_for

    return blocks_for(PREFIX_LEN + SUFFIX_MAX + MAX_NEW, BS)


# the spec phase's verify: 8 lanes at L = SPEC_K + 1 = 5 (L*G = 20 rows a
# kv head, past the decode split's 16), each at its own position, over
# tables of blocks_for(1024 + 64 + 5, 16) = 69 slots (the worst case
# with the verify's headroom); the draft's L=1 steps run over its own
# pools through the same tables.  Contexts put the 5 positions across a
# block edge (18: 13..17), ending on one (16, 1024) and starting on one
# (21: 16..20; 517: 512..516); the first lane sits at the cap
SPEC_K = 4
VERIFY_CTX = [MAX_CTX + MAX_NEW + SPEC_K + 1, 16, 18, 21, 517, 1024, 700]


def verify_t_slots() -> int:
    from tf_operator_tpu_torch.models.paging import blocks_for

    return blocks_for(MAX_CTX + MAX_NEW + SPEC_K + 1, BS)


# the decode split's edges at the kernel phase's table (68 slots of 16,
# 64 (kv head, lane) pairs: chunks of 8 slots, 128 keys): contexts that
# end inside the first chunk (100), on chunk boundaries (128, 512, 1024)
# and inside chunks; lane 7 is frozen, so all its chunks are scratch
EDGE_CTX = [1024, 100, 128, 512, 600, 1000, 700]


def paged_cases() -> list:
    """The kernel phases' cases: dicts of make_case's arguments (dtype,
    L, window, ring; optionally bs, ctx, h)."""
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        cases += [dict(dtype=dt, l=l, window=w, ring=False)
                  for l in (1, 512) for w in (None, 256)]
        cases.append(dict(dtype=dt, l=1, window=512, ring=True))
        # serve_loop's default block size, 64: past 48 KB of shared memory
        cases.append(dict(dtype=dt, l=1, window=None, ring=False, bs=64))
        # the split's edges, and a window that empties whole chunks
        cases += [dict(dtype=dt, l=1, window=w, ring=False, ctx=EDGE_CTX)
                  for w in (None, 300)]
        # L*G = 12 and 16 rows (split, G = 4), 16 and 17 rows at G = 1
        # (H = KV = 8: the largest split and the smallest direct call)
        cases += [dict(dtype=dt, l=l, window=None, ring=False)
                  for l in (3, 4)]
        cases += [dict(dtype=dt, l=l, window=None, ring=False, h=KV)
                  for l in (16, 17)]
        # the serve phase's longest prompt; block size 64 at prefill
        cases.append(dict(dtype=dt, l=974, window=None, ring=False))
        cases.append(dict(dtype=dt, l=512, window=None, ring=False, bs=64))
        # the handoff phase's decode, suffix fill and prefix write
        t = handoff_t_slots()
        cases += [dict(dtype=dt, l=l, window=None, ring=False, t_slots=t,
                       ctx=ctx)
                  for l, ctx in ((1, HANDOFF_CTX),
                                 (SUFFIX_MAX, [PREFIX_LEN + SUFFIX_MAX] * 7),
                                 (PREFIX_LEN, [PREFIX_LEN] * 7))]
        # the spec phase's verify (L = 5, 20 rows) and draft step (L = 1)
        cases += [dict(dtype=dt, l=l, window=None, ring=False,
                       t_slots=verify_t_slots(), ctx=VERIFY_CTX)
                  for l in (SPEC_K + 1, 1)]
    return cases


def int8_pools(case) -> list:
    """The case's K and V pools quantized over head_dim (models/quant,
    as the int8 block write does), with the scratch block poisoned:
    payload 127 and scale 1e4, so a masking fault would show."""
    from tf_operator_tpu_torch.models import quant

    out = []
    for name in ("k", "v"):
        qt = quant.quantize_tensor(case[name], axes=(3,))
        qt.q[0] = 127
        qt.scale[0] = 1e4
        out.append(qt)
    return out


def kernel_phase(int8: bool = False) -> dict:
    """K1, or K1q (int8=True: the same draws quantized by int8_pools),
    against its plain version on paged_cases(): live rows within
    PAGED_TOL, the frozen lane finalizing to 0, two launches with the
    same bits.  Then its time at decode and prefill (bf16 queries)
    beside the plain version, SDPA over the gathered (dequantized) view
    and the bound."""
    from tf_operator_tpu_torch.models import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = "[kernel1q]" if int8 else "[kernel]"
    plain = (pa.paged_attention_int8_plain if int8
             else pa.paged_attention_plain)

    def inputs(case):
        k, v = int8_pools(case) if int8 else (case["k"], case["v"])
        return (case["q"], k, v, case["table"], case["pos"])

    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    # the verify cases' own (the spec phase's L = 5 at VERIFY_CTX)
    verify_errs = dict(errs)
    for i, kw in enumerate(paged_cases()):
        dt, l = kw["dtype"], kw["l"]
        case = make_case(seed=SEED + i, **kw)
        bs, h = kw.get("bs", BS), kw.get("h", H)
        chunk = (pa.split_slots(l * h // KV, case["table"].shape[1], bs,
                                KV * B) if dt == torch.bfloat16 else 0)
        err = check_paged(
            case, inputs(case), plain, dt, B - 1,
            f"{tag} {str(dt)[6:]:8s} L={l:<4d} H={h} bs={bs} "
            f"window={kw['window']} ring={kw['ring']} ctx={case['ctx']} "
            f"split_slots={chunk}")
        errs[dt] = max(errs[dt], err)
        if l == SPEC_K + 1 and kw.get("ctx") is VERIFY_CTX:
            verify_errs[dt] = max(verify_errs[dt], err)

    timings = {}
    for name, l in (("decode", 1), ("prefill", 512),
                    ("verify", SPEC_K + 1)):
        # the verify: the spec phase's tables, lanes at ragged contexts
        case = make_case(torch.bfloat16, l, None, False, SEED + 100,
                         t_slots=verify_t_slots() if l == SPEC_K + 1
                         else None)
        timings[name] = paged_timing(
            case, inputs(case), plain, bound_ms(case, torch.bfloat16, int8),
            f"{tag} timing {name} bf16 q, {'int8' if int8 else 'bf16'} KV, "
            f"B={B} L={l} H={H} KV={KV} D={D} bs={BS} ctx={case['ctx']}")
    return dict(errs=errs, verify_errs=verify_errs, timings=timings)


def check_paged(case, args, plain, dt, frozen, label: str) -> float:
    """K1 or K1q on args (the wrapper's inputs) against its plain version:
    the live rows within PAGED_TOL, lane `frozen` (None: none) finalizing
    to 0, two launches with the same bits.  Returns the largest error."""
    from tf_operator_tpu_torch.models import paged_attention as pa

    w = case["window"]
    got = pa.paged_attention(*args, window=w)
    again = pa.paged_attention(*args, window=w)
    ref = plain(*args, window=w)
    torch.cuda.synchronize()
    live = slice(0, frozen)
    diff = (got[live].float() - ref[live].float()).abs()
    atol, rtol = PAGED_TOL[dt]
    ok = bool((diff <= atol + rtol * ref[live].float().abs()).all())
    same = torch.equal(got, again)
    frozen_zero = frozen is None or bool((got[frozen] == 0).all())
    err = float(diff.max())
    log(f"{label} max_abs_err={err:.3e} (atol {atol}, rtol {rtol}) "
        f"frozen_lane_zero={frozen_zero} repeat={same}")
    if not (ok and same and frozen_zero and torch.isfinite(got).all()):
        raise AssertionError(
            f"{label}: the kernel disagrees with its plain version or does "
            f"not repeat: err={err} bit_identical={same}")
    return err


def paged_timing(case, args, plain, bound: tuple, label: str) -> dict:
    """K1's or K1q's time on args (the wrapper's inputs) beside its plain
    version, SDPA over the gathered (dequantized) view with the case's
    ring and window mask, and `bound` (ms, "bytes" or "operations"); and
    the kernel's and SDPA's device time alone."""
    from tf_operator_tpu_torch.models import paged_attention as pa

    w = case["window"]
    sq, sk, sv, mask = sdpa_inputs(dict(case, k=args[1], v=args[2]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fn = lambda: sdpa(sq, sk, sv, attn_mask=mask, enable_gqa=True)
    # plain, kernel, kernel, plain: one card, in turns
    p1 = time_ms(lambda: plain(*args, window=w))
    k1 = time_ms(lambda: pa.paged_attention(*args, window=w))
    k2 = time_ms(lambda: pa.paged_attention(*args, window=w))
    p2 = time_ms(lambda: plain(*args, window=w))
    lib = time_ms(lib_fn)
    # device time alone: the launches queued behind a wait on the card
    kq = time_ms(lambda: pa.paged_attention(*args, window=w), queued=True)
    libq = time_ms(lib_fn, queued=True)
    bnd, by = bound
    log(f"{label}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
        f"sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by}); device time alone: "
        f"kernel {kq:.4f} ms, sdpa {libq:.4f} ms")
    return dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=lib,
                bound_ms=bnd, bound_by=by, device_ms=kq,
                library_device_ms=libq)


# --------------------------------------------------------- kernel-2 phase
# llama3_8b training shapes at batch 1 (train_llama's 8 x 8192 cut to the
# train phase's 1 x 2048)
TB, TS, TH, TKV, TD = 1, 2048, 32, 8, 128
FLASH = ("flash_fwd", "flash_dq", "flash_dkv")


def flash_case(dtype, s: int, seed: int, d: int = TD):
    """q [B, S, H, D], and k, v as the two halves of one fused
    [B, S, 2, KV, D] projection (strided views, as the model hands them
    over), and dO."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((TB, s, TH, d), generator=g)
    kv = torch.randn((TB, s, 2, TKV, d), generator=g)
    do = torch.randn((TB, s, TH, d), generator=g)
    q, kv, do = (t.to("cuda", dtype) for t in (q, kv, do))
    return q, kv[:, :, 0], kv[:, :, 1], do


def flash_delta(out, do):
    return (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bound_ms(which: str, dtype, s: int, causal: bool, window) -> tuple:
    """The least time the card could take for one kernel's work: the
    larger of its bytes (each input read once, each output written once)
    over HBM bandwidth and its products over the dtype's peak.  Products:
    2 flops per multiply-add over the visible (query, key) pairs of this
    case, for 2 matmuls (forward: QKᵀ, PV), 3 (dQ: QKᵀ, dO·Vᵀ, dS·K) or
    4 (dK/dV: QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q)."""
    esz = torch.finfo(dtype).bits // 8
    if not causal:
        pairs = s * s
    else:
        w = window or s
        pairs = sum(min(i + 1, w) for i in range(s))
    mm = {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4}[which]
    flops = mm * 2 * TB * TH * pairs * TD
    qo = TB * s * TH * TD * esz
    kv = TB * s * TKV * TD * esz
    stat = TB * TH * s * 4
    nbytes = {"flash_fwd": 2 * qo + 2 * kv + stat,           # q k v o lse
              "flash_dq": 3 * qo + 2 * kv + 2 * stat,        # + do delta dq
              "flash_dkv": 2 * qo + 4 * kv + 2 * stat}[which]  # + dk dv
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel2_phase() -> dict:
    """K2f, K2q and K2kv against their plain versions at the training
    shapes, bf16 and f32: causal; non-causal; window 512; and S=1000,
    which has no 128-aligned tiling.  The backward kernels take the plain
    forward's lse and delta, so each kernel is held to its own plain
    version.  Two launches must give the same bits.  Then each kernel's
    time beside its plain version, SDPA and the bound (bf16, causal)."""
    from tf_operator_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # f32: the kernels sum 64-wide tiles in another order than the whole-
    # sequence einsums (and fold the forward by online softmax), ~1e-6 on
    # O(1) values.  bf16: the outputs, p and dS are rounded to bf16 (2^-8
    # relative), at a running instead of the final maximum in the forward.
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    errs = {name: 0.0 for name in FLASH}
    # the training shapes, then the tensor-core kernels' edges: at D = 64
    # a tail tile (S = 1000), one tile (S = 64), a window that starts the
    # kv run past tile 0, and no mask at all; at D = 128 a lone row past
    # a whole tile (S = 129) and three tiles unmasked (S = 192)
    cases = [(dt, s, causal, w, d)
             for (s, causal, w, d) in (
                 (TS, True, None, TD), (TS, False, None, TD),
                 (TS, True, 512, TD), (1000, True, None, TD),
                 (1000, True, None, 64), (64, True, None, 64),
                 (1000, True, 512, 64), (1000, False, None, 64),
                 (129, True, None, TD), (192, False, None, TD))
             for dt in (torch.bfloat16, torch.float32)]
    for i, (dt, s, causal, w, d) in enumerate(cases):
        q, k, v, do = flash_case(dt, s, SEED + 10 + i, d)
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, w)
        delta = flash_delta(out_p, do)
        bwd = (q, k, v, do, lse_p, delta, causal, w)
        want = {"flash_fwd": (out_p, lse_p),
                "flash_dq": (fa.flash_dq_plain(*bwd),),
                "flash_dkv": fa.flash_dkv_plain(*bwd)}
        runs = [{"flash_fwd": fa.flash_fwd(q, k, v, causal, w),
                 "flash_dq": (fa.flash_dq(*bwd),),
                 "flash_dkv": fa.flash_dkv(*bwd)} for _ in range(2)]
        torch.cuda.synchronize()
        line = []
        for name in FLASH:
            same = all(torch.equal(a, b)
                       for a, b in zip(runs[0][name], runs[1][name]))
            err = 0.0
            ok = same
            for got, ref in zip(runs[0][name], want[name]):
                diff = (got.float() - ref.float()).abs()
                err = max(err, float(diff.max()))
                ok &= bool(torch.isfinite(got).all())
                ok &= bool((diff <= tol[dt] * (1 + ref.float().abs())).all())
            if dt == torch.bfloat16:
                errs[name] = max(errs[name], err)
            line.append(f"{name} err={err:.3e} repeat={same}")
            if not ok:
                raise AssertionError(
                    f"[kernel2] {name} disagrees with its plain version or "
                    f"does not repeat: dtype={dt} S={s} D={d} "
                    f"causal={causal} window={w} err={err} "
                    f"bit_identical={same}")
        log(f"[kernel2] {str(dt)[6:]:8s} S={s} D={d} causal={causal} "
            f"window={w} (atol=rtol={tol[dt]}): " + ", ".join(line))
        del runs, want, bwd

    q, k, v, do = flash_case(torch.bfloat16, TS, SEED + 30)
    out, lse = fa.flash_fwd(q, k, v, True)
    delta = flash_delta(out, do)
    bwd = (q, k, v, do, lse, delta, True)
    fns = {"flash_fwd": (lambda: fa.flash_fwd(q, k, v, True),
                         lambda: fa.flash_fwd_plain(q, k, v, True)),
           "flash_dq": (lambda: fa.flash_dq(*bwd),
                        lambda: fa.flash_dq_plain(*bwd)),
           "flash_dkv": (lambda: fa.flash_dkv(*bwd),
                         lambda: fa.flash_dkv_plain(*bwd))}
    # the yardstick: SDPA (forward, and its backward through autograd,
    # which yields dq, dk and dv together); the port never calls it
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach() for x in (q, k, v))
    sdpa_fwd = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    with torch.no_grad():
        lib_fwd = time_ms(sdpa_fwd)
        lib_fwd_q = time_ms(sdpa_fwd, queued=True)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    o_s = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(o_s, (qg, kg, vg), dot,
                                           retain_graph=True)
    lib_bwd = time_ms(sdpa_bwd)
    lib_bwd_q = time_ms(sdpa_bwd, queued=True)
    timings = {}
    for name, (kern, plain) in fns.items():
        p1 = time_ms(plain)
        k1 = time_ms(kern)
        k2 = time_ms(kern)
        p2 = time_ms(plain)
        # device time alone: the launch queued behind a wait on the card
        kq = time_ms(kern, queued=True)
        bnd, by = flash_bound_ms(name, torch.bfloat16, TS, True, None)
        fwd = name == "flash_fwd"
        lib, lib_q = (lib_fwd, lib_fwd_q) if fwd else (lib_bwd, lib_bwd_q)
        timings[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                             library_ms=lib, bound_ms=bnd, bound_by=by,
                             device_ms=kq, library_device_ms=lib_q)
        log(f"[kernel2] timing {name} bf16 causal B={TB} S={TS} H={TH} "
            f"KV={TKV} D={TD}: kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms, sdpa {'fwd' if fwd else 'bwd'} "
            f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}); device time alone: "
            f"kernel {kq:.4f} ms, sdpa {lib_q:.4f} ms")
    # SDPA's backward yields dq, dk and dv together: its function is the
    # pair's
    pair = timings["flash_dq"]["device_ms"] + timings["flash_dkv"]["device_ms"]
    log(f"[kernel2] K2q + K2kv, device time alone: {pair:.4f} ms against "
        f"sdpa bwd {lib_bwd_q:.4f} ms ({pair / lib_bwd_q:.2f}x)")
    return dict(errs=errs, timings=timings)


# ------------------------------------------------------------- serve phase
def prompts_for(cfg, n: int, lo: int, hi: int, seed: int):
    g = torch.Generator(device="cpu").manual_seed(seed)
    lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
    return [torch.randint(0, cfg.vocab_size, (m,), generator=g)
            for m in lens]


def tel_line(stats) -> str:
    """The telemetry a serving run reports beside its throughput
    (models/telemetry.ServeStats; host clock, the memory peak from
    torch's allocator)."""
    tpot = ("None" if stats.tpot_mean_s is None
            else f"{stats.tpot_mean_s:.6f}")
    return (f"tpot_mean_s={tpot} "
            f"e2e_latency_mean_s={stats.e2e_latency_mean_s:.4f} "
            f"e2e_latency_max_s={stats.e2e_latency_max_s:.4f} "
            f"occupancy_mean={stats.occupancy_mean:.4f} "
            f"kv_block_occupancy_mean={stats.kv_block_occupancy_mean:.2f} "
            f"hbm_peak_bytes={json.dumps(stats.hbm_peak_bytes)}")


def check_spans(tracer, stats, n: int, tag: str) -> None:
    """A private tracer's serving spans: one root a request, each with
    the queued, prefill and decode children, and a Chrome export that
    parses with one complete event a span."""
    roots = tracer.traces()
    kids = [[c.name for c in r.children] for r in roots]
    reqs = sorted(r.attrs["request"] for r in roots)
    doc = json.loads(tracer.export_chrome_json())
    n_spans = sum(1 for r in roots for _ in r.walk())
    if (reqs != list(range(n)) or stats.requests != n
            or any(k != ["queued", "prefill", "decode"] for k in kids)
            or len(doc["traceEvents"]) != n_spans
            or not all(e["ph"] == "X" and e["cat"] == "serving"
                       for e in doc["traceEvents"])):
        raise AssertionError(
            f"[{tag}] spans: roots for requests {reqs} of {n}, children "
            f"{kids[:2]}, {len(doc['traceEvents'])} events of {n_spans}")


def serve_phase() -> dict:
    from tf_operator_tpu_torch.engine.tracing import Tracer
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop
    from tf_operator_tpu_torch.models.telemetry import ServeTelemetry

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
    tracer = Tracer()
    pa.reset_launches()
    results, stats = serve_loop(model, prompts, max_new_tokens=MAX_NEW,
                                return_stats=True,
                                telemetry=ServeTelemetry(tracer=tracer), **kw)
    torch.cuda.synchronize()
    launches, mma = pa.launches, pa.launches_mma
    hook.remove()
    peak = torch.cuda.max_memory_allocated()
    check_spans(tracer, stats, len(prompts), "serve")
    dev_key = f"cuda:{torch.cuda.current_device()}"
    if not stats.hbm_peak_bytes.get(dev_key, 0) > 0:
        raise AssertionError(f"[serve] hbm_peak_bytes "
                             f"{stats.hbm_peak_bytes} has no {dev_key}")

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
    if mma != launches:
        raise AssertionError(f"[serve] {mma} of {launches} bf16-query K1 "
                             f"calls took the tensor-core design")
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
        f"kernel_launches={launches} tensor_core_launches={mma} "
        f"max_memory_allocated_gib={peak / 2**30:.3f}")
    log(f"[serve] telemetry: {tel_line(stats)}; spans: "
        f"{len(tracer.traces())} request roots of queued/prefill/decode, "
        f"Chrome export parsed")
    # the spec and handoff phases serve on the same model
    return dict(launches=launches, model=model, prompts=prompts,
                tokens=[r.tokens for r in results])


def ttft_pcts(stats) -> tuple:
    """TTFT p50 and p99 of a run (with 16 requests p99 is the maximum)."""
    ttft = sorted(r["ttft_s"] for r in stats.per_request)
    pct = lambda p: ttft[min(len(ttft) - 1, math.ceil(p * len(ttft)) - 1)]
    return pct(0.5), pct(0.99)


# -------------------------------------------------------------- spec phase
SPEC_DRAFT_LAYERS, SPEC_ROUNDS, SPEC_WITNESS = 8, 4, 8


def early_exit_draft(model, n_layers: int):
    """The target's own first n_layers as a draft (bench.py's early-exit
    draft): the embedding, those blocks, the final norm and the head,
    the same tensors on the card (from_params copies none of them)."""
    from tf_operator_tpu_torch.models import llama

    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    params = {k: v for k, v in model.state_dict().items()
              if not k.startswith("blocks.")
              or int(k.split(".")[1]) < n_layers}
    return llama.Llama.from_params(cfg, params,
                                   device=model.embed.device)


def spec_phase(model, prompts, base_tokens) -> dict:
    """Speculative serving of the serve phase's llama3_8b (bf16, 32
    layers, its seeded weights) and its 16 prompts, 64 new tokens,
    greedy, 8 slots, spec_k = SPEC_K, SPEC_ROUNDS rounds a block; the
    draft is the target's own first 8 layers.  (a) the slot scheduler,
    (b) the continuous one: (b) gives (a)'s tokens.  Then the self-draft
    witness (the target as its own draft, 8 requests): the acceptance
    rate must pass 0.9 (a broken verify reads near 0).  In every run K1
    launches equal target layers x target calls + draft layers x draft
    calls, every one on the tensor cores."""
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop

    t_phase = time.perf_counter()
    cfg = model.cfg
    draft = early_exit_draft(model, SPEC_DRAFT_LAYERS)
    kw = dict(slots=8, block_size=BS, steps_per_sync=SPEC_ROUNDS,
              spec_k=SPEC_K, device="cuda", return_stats=True)
    # warm-up on two short requests
    serve_loop(model, [p[:64] for p in prompts[:2]], max_new_tokens=8,
               draft=draft, **kw)
    calls = {"target": 0, "draft": 0}
    hooks = [m.register_forward_hook(
        lambda *_, n=name: calls.__setitem__(n, calls[n] + 1))
        for name, m in (("target", model), ("draft", draft))]
    launches = []

    def run(tag, reqs, drafter, **extra):
        calls.update(target=0, draft=0)
        pa.reset_launches()
        torch.cuda.synchronize()
        out, stats = serve_loop(model, reqs, max_new_tokens=MAX_NEW,
                                draft=drafter, **kw, **extra)
        torch.cuda.synchronize()
        # the self-draft's draft calls are the target's module's
        want = (cfg.n_layers * calls["target"]
                + drafter.cfg.n_layers * calls["draft"])
        if pa.launches != want or pa.launches == 0:
            raise AssertionError(
                f"[spec] ({tag}) K1 launched {pa.launches} times for "
                f"{calls} model calls, {want} expected")
        if pa.launches_mma != pa.launches or pa.launches_int8:
            raise AssertionError(
                f"[spec] ({tag}) {pa.launches_mma} of {pa.launches} K1 "
                f"calls on the tensor cores, K1q {pa.launches_int8}")
        for i, r in enumerate(out):
            if len(r.tokens) != MAX_NEW or not all(
                    0 <= t < cfg.vocab_size for t in r.tokens):
                raise AssertionError(f"[spec] ({tag}) request {i}: "
                                     f"{len(r.tokens)} tokens or one out "
                                     f"of vocab")
        launches.append(pa.launches)
        p50, p99 = ttft_pcts(stats)
        log(f"[spec] ({tag}) tokens={stats.total_tokens} "
            f"wall_s={stats.wall_time_s:.4f} "
            f"tokens_per_s={stats.tokens_per_sec:.2f} ttft_p50_s={p50:.4f} "
            f"ttft_p99_s={p99:.4f} prefill_s={stats.prefill_time_s:.4f} "
            f"decode_s={stats.decode_time_s:.4f} "
            f"accepted_drafts={stats.accepted_drafts} "
            f"proposed_drafts={stats.proposed_drafts} "
            f"acceptance_rate={stats.acceptance_rate:.4f} "
            f"wasted_lane_steps={stats.wasted_lane_steps} "
            f"target_calls={calls['target']} draft_calls={calls['draft']} "
            f"kernel_launches={pa.launches} "
            f"tensor_core_launches={pa.launches_mma}")
        log(f"[spec] ({tag}) telemetry: {tel_line(stats)}")
        return out, stats

    slot, st_a = run("a slot", prompts, draft)
    cont, st_b = run("b continuous", prompts, draft, scheduler="continuous")
    for i, (r, w) in enumerate(zip(cont, slot)):
        if r.tokens != w.tokens:
            raise AssertionError(f"[spec] (b) request {i}: {r.tokens} != "
                                 f"(a)'s {w.tokens}")
    same = sum(r.tokens == w for r, w in zip(slot, base_tokens))
    log(f"[spec] llama3_8b target, its first {SPEC_DRAFT_LAYERS} layers as "
        f"the draft, spec_k={SPEC_K}, {SPEC_ROUNDS} rounds a block, "
        f"{len(prompts)} requests x {MAX_NEW} tokens: (b) tokens == (a) "
        f"tokens for all {len(prompts)}; {same} of {len(prompts)} requests "
        f"give the serve phase's non-speculative tokens (informational: "
        f"bf16 at L={SPEC_K + 1} and at L=1 may round differently)")
    hooks[1].remove()
    _, st_w = run("self-draft witness", prompts[:SPEC_WITNESS], model)
    hooks[0].remove()
    if not st_w.acceptance_rate > 0.9:
        raise AssertionError(f"[spec] the self-draft witness accepted "
                             f"{st_w.acceptance_rate} of its drafts")
    log(f"[spec] K1 launches per run (a, b, witness): {launches}, "
        f"{sum(launches)} in all; phase {time.perf_counter() - t_phase:.1f} s")
    del draft
    return dict(launches=sum(launches))


# ------------------------------------------------------------ dense phase
DENSE_BATCH, DENSE_PROMPT, DENSE_CHUNK = 8, 512, 128


def ring_bytes(cfg, lanes: int, slots: int) -> int:
    """Bytes of dense rings (or of a paged pool of `lanes` blocks of
    `slots` positions): K and V of every layer, in cfg.dtype."""
    return (2 * cfg.n_layers * lanes * slots * cfg.n_kv_heads * cfg.head_dim
            * torch.finfo(cfg.dtype).bits // 8)


def dense_phase(model, prompts, paged_tokens) -> None:
    """Dense-ring decoding of the serve phase's llama3_8b (bf16, 32
    layers, its seeded weights): serve_loop(paged=False) over its 16
    prompts, 64 new tokens, 8 lanes, under (a) the slot and (b) the
    continuous scheduler, whose tokens must be equal; how many requests
    give the paged serve phase's tokens is printed (bf16: K1 and the
    dense einsum sum in other orders).  Then generate on a batch of 8
    equal 512-token prompts, one pass and in chunks of 128 (rows that
    agree printed).  Then the self-draft witnesses (the target as its
    own draft, spec_k 4) over that batch: serve_loop(paged=False) and
    speculative_generate in bf16 must accept more than 0.5 (sound runs
    read 0.85-0.90, bf16 near ties flipping between the draft's L=1 and
    the verify's L=5 rounding; a broken verify reads near 0), and
    speculative_generate over the same weights upcast to f32 more than
    0.9 (rounding flips almost no tie there).  No kernel reads a dense
    ring: K1 and K1q are launched 0 times in every run."""
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop
    from tf_operator_tpu_torch.models.speculative import speculative_generate

    t_phase = time.perf_counter()
    cfg = model.cfg
    kw = dict(slots=8, steps_per_sync=8, device="cuda", paged=False,
              return_stats=True)
    serve_loop(model, [p[:64] for p in prompts[:2]], max_new_tokens=8, **kw)
    calls = [0]
    hook = model.register_forward_hook(
        lambda *_: calls.__setitem__(0, calls[0] + 1))

    def no_kernel(tag):
        if pa.launches or pa.launches_int8:
            raise AssertionError(f"[dense] ({tag}) K1 {pa.launches}, K1q "
                                 f"{pa.launches_int8} launches on dense "
                                 f"rings")

    runs = {}
    for tag, sched in (("a slot", "slot"), ("b continuous", "continuous")):
        calls[0] = 0
        pa.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, st = serve_loop(model, prompts, max_new_tokens=MAX_NEW,
                             scheduler=sched, **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        no_kernel(tag)
        for i, r in enumerate(out):
            if len(r.tokens) != MAX_NEW or not all(
                    0 <= t < cfg.vocab_size for t in r.tokens):
                raise AssertionError(f"[dense] ({tag}) request {i}: "
                                     f"{len(r.tokens)} tokens or one out "
                                     f"of vocab")
        if st.paged or st.kv_blocks_total:
            raise AssertionError(f"[dense] ({tag}) stats say paged")
        p50, p99 = ttft_pcts(st)
        log(f"[dense] ({tag}) tokens={st.total_tokens} "
            f"wall_s={st.wall_time_s:.4f} "
            f"tokens_per_s={st.tokens_per_sec:.2f} ttft_p50_s={p50:.4f} "
            f"ttft_p99_s={p99:.4f} prefill_s={st.prefill_time_s:.4f} "
            f"decode_s={st.decode_time_s:.4f} model_calls={calls[0]} "
            f"kernel_launches=0 max_memory_allocated_gib="
            f"{peak / 2**30:.3f}")
        log(f"[dense] ({tag}) telemetry: {tel_line(st)}")
        runs[sched] = [r.tokens for r in out]
    if runs["slot"] != runs["continuous"]:
        bad = [i for i, (a, b) in enumerate(zip(runs["slot"],
                                                runs["continuous"]))
               if a != b]
        raise AssertionError(f"[dense] (b) continuous tokens differ from "
                             f"(a) slot's at requests {bad}")
    same = sum(a == b for a, b in zip(runs["slot"], paged_tokens))
    longest = max(int(p.shape[0]) for p in prompts)
    c = llama.auto_cache_len(cfg, longest, longest + MAX_NEW)
    pool = 8 * -(-(longest + MAX_NEW) // BS) + 1
    log(f"[dense] {len(prompts)} requests x {MAX_NEW} tokens: (b) tokens "
        f"== (a) tokens for all; {same} of {len(prompts)} requests give "
        f"the paged serve phase's tokens (informational: K1 and the dense "
        f"einsum round bf16 sums in other orders); dense rings 8 lanes x "
        f"{c} slots = {ring_bytes(cfg, 8, c) / 2**30:.4f} GiB, the paged "
        f"pool for the same requests {pool} blocks x {BS} = "
        f"{ring_bytes(cfg, pool, BS) / 2**30:.4f} GiB")

    g = torch.Generator(device="cpu").manual_seed(SEED + 40)
    batch = torch.randint(0, cfg.vocab_size,
                          (DENSE_BATCH, DENSE_PROMPT), generator=g).cuda()
    gen = {}
    for tag, chunk in (("one pass", None), ("chunked", DENSE_CHUNK)):
        calls[0] = 0
        pa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen[tag] = llama.generate(model, batch, MAX_NEW, device="cuda",
                                  prefill_chunk=chunk)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        no_kernel(f"generate {tag}")
        if gen[tag].shape != (DENSE_BATCH, MAX_NEW) or not bool(
                ((gen[tag] >= 0) & (gen[tag] < cfg.vocab_size)).all()):
            raise AssertionError(f"[dense] generate {tag}: shape "
                                 f"{tuple(gen[tag].shape)} or a token out "
                                 f"of vocab")
        log(f"[dense] generate ({tag}) {DENSE_BATCH} x {DENSE_PROMPT} "
            f"prompt tokens + {MAX_NEW} new: wall_s={dt:.4f} "
            f"tokens_per_s={DENSE_BATCH * MAX_NEW / dt:.2f} "
            f"model_calls={calls[0]}")
    rows = int((gen["one pass"] == gen["chunked"]).all(dim=1).sum())
    log(f"[dense] generate: {rows} of {DENSE_BATCH} rows one pass == "
        f"chunked (informational: bf16 segments round differently)")
    hook.remove()

    def witness(tag, reqs, fn):
        """A self-draft run (the target as its own draft, spec_k=SPEC_K):
        its acceptance, launches checked, timed."""
        pa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, acc, prop = fn(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        no_kernel(tag)
        rate = acc / max(prop, 1)
        log(f"[dense] {tag}, the target as its own draft, spec_k={SPEC_K}: "
            f"accepted {acc} of {prop}, acceptance_rate={rate:.4f}, "
            f"wall_s={dt:.4f} tokens_per_s="
            f"{len(reqs) * MAX_NEW / dt:.2f}")
        return out, rate

    def serve_spec(reqs):
        out, st = serve_loop(model, reqs, max_new_tokens=MAX_NEW, draft=model,
                             spec_k=SPEC_K, **dict(kw, steps_per_sync=
                                                   SPEC_ROUNDS))
        return out, st.accepted_drafts, st.proposed_drafts

    def spec_gen(target):
        def fn(batch_):
            out, st = speculative_generate(target, target, batch_, MAX_NEW,
                                           k=SPEC_K, device="cuda",
                                           return_stats=True)
            return out, st["accepted_drafts"], st["proposed_drafts"]
        return fn

    # the self-draft witnesses over the generate batch.  In bf16 the
    # draft's L=1 steps and the verify's L=k+1 pass round near ties apart
    # and reject some drafts (sound runs read 0.85-0.90 here, a broken
    # verify near 0); the same weights in f32 leave almost no tie that
    # rounding flips, so there the rate must pass 0.9
    _, r_serve = witness("serve_loop(paged=False) over the generate batch, "
                         "bf16", list(batch.cpu()), serve_spec)
    spec, r_gen = witness("speculative_generate over the generate batch, "
                          "bf16", batch, spec_gen(model))
    agree = int((spec == gen["one pass"]).all(dim=1).sum())
    log(f"[dense] speculative_generate bf16: {agree} of {DENSE_BATCH} rows "
        f"== generate's (informational: bf16 at L={SPEC_K + 1} and at L=1 "
        f"may round differently)")
    for tag, rate in (("serve_loop", r_serve), ("speculative_generate",
                                                r_gen)):
        if not rate > 0.5:
            raise AssertionError(f"[dense] the bf16 {tag} self-draft "
                                 f"witness accepted {rate} of its drafts")
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = llama.Llama.from_params(
        dataclasses.replace(cfg, dtype=torch.float32),
        {k: v.float() for k, v in model.state_dict().items()}, device="cuda")
    spec32, r32 = witness("speculative_generate over the generate batch, "
                          "f32 (the same weights upcast)", batch,
                          spec_gen(f32))
    gen32 = llama.generate(f32, batch, MAX_NEW, device="cuda")
    agree32 = int((spec32 == gen32).all(dim=1).sum())
    del f32
    torch.cuda.empty_cache()
    log(f"[dense] speculative_generate f32: {agree32} of {DENSE_BATCH} rows "
        f"== f32 generate's; acceptance bf16 {r_gen:.4f} -> f32 {r32:.4f} "
        f"on the same batch and weights")
    if not r32 > 0.9:
        raise AssertionError(f"[dense] the f32 speculative_generate "
                             f"self-draft witness accepted {r32} of its "
                             f"drafts")
    log(f"[dense] phase {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()


# ------------------------------------------------------ dense-parity phase
def dense_parity_phase() -> None:
    """Full width, 2 layers, f32 (TF32 off): dense decoding on the card
    gives the CPU's tokens: generate one pass and chunked;
    speculative_generate with the target as its own draft, and over a
    windowed ring smaller than the sequence (window 32, ring 40, chunk
    8: the verify's write wraps); serve_loop(paged=False) under both
    schedulers (schedules too), over an unaligned prefix, with
    speculation (a 1-layer draft), and with int8 weights and KV over the
    spec-parity phase's int8 requests; and on the card, dense serving
    gives paged serving's tokens."""
    from tf_operator_tpu_torch.models import bridge, llama, quant
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop
    from tf_operator_tpu_torch.models.speculative import speculative_generate

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama.llama3_8b(n_layers=2, dtype=torch.float32)
    wcfg = llama.llama3_8b(n_layers=2, dtype=torch.float32,
                           sliding_window=32, max_len=512)
    dcfg = llama.llama3_8b(n_layers=1, dtype=torch.float32)

    def both(params, c):
        return (llama.Llama.from_params(c, params, device="cuda"),
                llama.Llama.from_params(
                    c, {k: v.to("cpu") for k, v in params.items()},
                    device="cpu"))

    def same(tag, fn):
        """fn(model index, device) on the card and the CPU: equal."""
        t0 = time.perf_counter()
        got = fn(0, "cuda")
        t1 = time.perf_counter()
        want = fn(1, "cpu")
        t2 = time.perf_counter()
        if got != want:
            raise AssertionError(f"[dense-parity] ({tag}) cuda {got} != "
                                 f"cpu {want}")
        log(f"[dense-parity] ({tag}) identical on cuda and cpu; cuda "
            f"{t1 - t0:.1f} s, cpu {t2 - t1:.1f} s")
        return got

    params = bridge.init_params(cfg, SEED + 41, device="cuda")
    m = both(params, cfg)
    w = both(params, wcfg)   # the same weights under a window of 32
    del params
    d = both(bridge.init_params(dcfg, SEED + 42, device="cuda"), dcfg)
    pa.reset_launches()
    g = torch.Generator(device="cpu").manual_seed(SEED + 43)
    batch = torch.randint(0, cfg.vocab_size, (2, 48), generator=g)
    toks = lambda t: t.cpu().tolist()
    same("generate one pass", lambda i, dev: toks(llama.generate(
        m[i], batch, 8, device=dev)))
    same("generate chunked", lambda i, dev: toks(llama.generate(
        m[i], batch, 8, device=dev, prefill_chunk=16)))
    same("speculative_generate, self-draft", lambda i, dev: toks(
        speculative_generate(m[i], m[i], batch, 8, k=3, device=dev)))
    ring = dict(cache_len=40, prefill_chunk=8)
    wrapped = same("speculative_generate, window 32 over a 40-slot ring",
                   lambda i, dev: toks(speculative_generate(
                       w[i], w[i], batch, 8, k=3, device=dev,
                       draft_cache_len=40, **ring)))
    if wrapped != toks(llama.generate(w[0], batch, 8, device="cuda",
                                      **ring)):
        raise AssertionError("[dense-parity] windowed speculation differs "
                             "from generate on the card")
    reqs = prompts_for(cfg, 4, 24, 96, SEED + 44)
    pfx = prompts_for(cfg, 1, 40, 40, SEED + 45)[0]
    sufs = prompts_for(cfg, 4, 8, 40, SEED + 46)
    kw = dict(slots=2, max_new_tokens=[6, 12, 8, 10], steps_per_sync=4,
              paged=False)
    sched = lambda rs: [(r.tokens, r.admitted_at_step, r.finished_at_step,
                         r.slot, r.accepted_drafts, r.proposed_drafts)
                        for r in rs]
    slot = same("serve slot", lambda i, dev: sched(serve_loop(
        m[i], reqs, device=dev, **kw)))
    same("serve continuous", lambda i, dev: sched(serve_loop(
        m[i], reqs, device=dev, scheduler="continuous", **kw)))
    same("serve prefix", lambda i, dev: sched(serve_loop(
        m[i], sufs, device=dev, shared_prefix=pfx, **kw)))
    same("serve speculative", lambda i, dev: sched(serve_loop(
        m[i], reqs, device=dev, draft=d[i], spec_k=3, **kw)))
    if pa.launches or pa.launches_int8:
        raise AssertionError("[dense-parity] a kernel read a dense ring")
    paged = serve_loop(m[0], reqs, device="cuda", block_size=BS,
                       **{k: v for k, v in kw.items() if k != "paged"})
    if [r.tokens for r in paged] != [t[0] for t in slot]:
        raise AssertionError("[dense-parity] dense tokens on the card "
                             "differ from paged tokens")
    paged_k1 = pa.launches
    del m, w, d
    torch.cuda.empty_cache()
    # int8 weights and KV over the spec-parity phase's int8 requests
    q = both(int8_params(cfg, SEED + 7), cfg)
    dq = quant.make_dequantizer(torch.float32)
    pa.reset_launches()
    same("serve int8 weights and KV", lambda i, dev: sched(serve_loop(
        q[i], prompts_for(cfg, 4, 24, 96, SEED + 3)[:2], device=dev,
        scheduler="continuous", kv_quant=True, prefill_chunk=32,
        params_transform=dq, slots=2, max_new_tokens=[4, 8],
        steps_per_sync=4, paged=False)))
    if pa.launches or pa.launches_int8:
        raise AssertionError("[dense-parity] a kernel read a dense ring")
    del q
    torch.cuda.empty_cache()
    log(f"[dense-parity] 2 layers f32: every run identical on cuda and "
        f"cpu, no kernel launched on a dense ring; dense == paged tokens "
        f"on cuda (the paged run: {paged_k1} K1 launches); phase "
        f"{time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------- spec-parity phase
def int8_tie_witness(models, prompt) -> None:
    """Informational: one prefill of `prompt` by an int8-weight model on
    the card and on the CPU, with int8 and with f32 KV: the int8 KV
    values that differ between the two devices, the largest logit
    difference, and each device's top two tokens and logits (a greedy
    choice whose top two lie closer than that difference can differ)."""
    from tf_operator_tpu_torch.models import paging

    for kv_quant in (True, False):
        res = []
        for m in models:
            dev = m.embed.device
            n = paging.blocks_for(int(prompt.shape[0]), BS)
            cache = paging.init_block_pool(m.cfg, n, BS, device=dev,
                                           kv_quant=kv_quant)
            table = torch.arange(1, n + 1, dtype=torch.int32,
                                 device=dev)[None]
            with torch.inference_mode():
                lg = m(prompt[None].to(dev), cache, 0, table)[0, -1]
            res.append((lg.float().cpu(), [t.cpu() for t in
                                           paging._leaves(cache)]))
        (lg_g, pool_g), (lg_c, pool_c) = res
        flips = (sum(int((a != b).sum()) for a, b in zip(pool_g, pool_c)
                     if a.dtype == torch.int8) if kv_quant else 0)
        top = [torch.topk(lg, 2) for lg in (lg_g, lg_c)]
        log(f"[spec-parity] int8 weights, {'int8' if kv_quant else 'f32'} "
            f"KV, one {int(prompt.shape[0])}-token prefill: int8 KV values "
            f"differing cuda/cpu {flips}; max logit diff "
            f"{float((lg_g - lg_c).abs().max()):.3e}; top two cuda "
            f"{top[0].indices.tolist()} {top[0].values.tolist()}, cpu "
            f"{top[1].indices.tolist()} {top[1].values.tolist()}")


def spec_parity_phase() -> dict:
    """Full width, 2 layers, f32 (TF32 off), a 1-layer draft from another
    seed, spec_k 3: the card's greedy tokens, schedule and per-request
    accepted/proposed drafts equal the CPU's under both schedulers, over
    an unaligned shared prefix (a CoW block in both pools), with the
    target as its own draft (rounds that accept), and with int8 weights
    and KV and an int8 draft through draft_transform (K1q; over the
    parity-int8 phase's target, first two requests and chunking); the card's
    speculative tokens equal its non-speculative ones.  Then
    int8_tie_witness, informational."""
    from tf_operator_tpu_torch.models import bridge, llama, quant
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama.llama3_8b(n_layers=2, dtype=torch.float32)
    dcfg = llama.llama3_8b(n_layers=1, dtype=torch.float32)

    def both(params, c):
        on_card = llama.Llama.from_params(c, params, device="cuda")
        on_cpu = llama.Llama.from_params(
            c, {k: v.to("cpu") for k, v in params.items()}, device="cpu")
        return on_card, on_cpu

    m_gpu, m_cpu = both(bridge.init_params(cfg, SEED + 31, device="cuda"),
                        cfg)
    d_gpu, d_cpu = both(bridge.init_params(dcfg, SEED + 32, device="cuda"),
                        dcfg)
    prompts = prompts_for(cfg, 4, 24, 96, SEED + 33)
    pfx = prompts_for(cfg, 1, 40, 40, SEED + 34)[0]
    sufs = prompts_for(cfg, 4, 8, 40, SEED + 35)
    kw = dict(slots=2, max_new_tokens=[6, 16, 10, 12], block_size=BS,
              steps_per_sync=2, spec_k=3)
    sched = lambda rs: [(r.tokens, r.admitted_at_step, r.finished_at_step,
                         r.slot, r.accepted_drafts, r.proposed_drafts,
                         r.kv_blocks) for r in rs]
    out = {}

    def check(tag, models, reqs, **extra):
        (tg, dg), (tc, dc) = models
        run_kw = dict(kw, **extra)
        pa.reset_launches()
        t0 = time.perf_counter()
        got = serve_loop(tg, reqs, device="cuda", draft=dg, **run_kw)
        torch.cuda.synchronize()
        n_k1, n_k1q = pa.launches, pa.launches_int8
        t1 = time.perf_counter()
        want = serve_loop(tc, reqs, device="cpu", draft=dc, **run_kw)
        t2 = time.perf_counter()
        if sched(got) != sched(want):
            raise AssertionError(f"[spec-parity] ({tag}) cuda {sched(got)} "
                                 f"!= cpu {sched(want)}")
        acc = [(r.accepted_drafts, r.proposed_drafts) for r in got]
        log(f"[spec-parity] ({tag}) tokens, schedule and drafts identical "
            f"on cuda and cpu: accepted/proposed {acc}; K1 launches {n_k1}, "
            f"K1q {n_k1q}; cuda {t1 - t0:.1f} s, cpu {t2 - t1:.1f} s")
        out[tag] = (got, n_k1, n_k1q)
        return got

    pair = ((m_gpu, d_gpu), (m_cpu, d_cpu))
    slot = check("slot", pair, prompts)
    check("continuous", pair, prompts, scheduler="continuous")
    check("prefix", pair, sufs, shared_prefix=pfx)
    plain = serve_loop(m_gpu, prompts, device="cuda",
                       **{k: v for k, v in kw.items() if k != "spec_k"})
    if [r.tokens for r in slot] != [r.tokens for r in plain]:
        raise AssertionError("[spec-parity] speculative tokens on the card "
                             "differ from its non-speculative tokens")
    # the target as its own draft: rounds that accept (a random draft,
    # or the first layer of random weights at this width, accepts none)
    got = check("self-draft", ((m_gpu, m_gpu), (m_cpu, m_cpu)), prompts)
    if sum(r.accepted_drafts for r in got) == 0:
        raise AssertionError("[spec-parity] the self-draft accepted "
                             "nothing")
    del m_gpu, m_cpu, d_gpu, d_cpu, pair
    torch.cuda.empty_cache()
    # int8 weights and KV, an int8 draft (K1q at the verify shape), over
    # the parity-int8 phase's target, first two requests and chunking:
    # int8 KV turns last-bit f32 differences into flipped int8 values,
    # so card = CPU holds only where no greedy choice is a near tie (the
    # witness below measures how near).  Two requests and short budgets:
    # the CPU dequantizes each int8 weight, the 0.5 G-element lm_head
    # included, at every model call, four calls a round
    q_pair = list(zip(both(int8_params(cfg, SEED + 7), cfg),
                      both(int8_params(dcfg, SEED + 37), dcfg)))
    dq = quant.make_dequantizer(torch.float32)
    check("int8", q_pair, prompts_for(cfg, 4, 24, 96, SEED + 3)[:2],
          scheduler="continuous", kv_quant=True, prefill_chunk=32,
          max_new_tokens=[4, 8], params_transform=dq, draft_transform=dq)
    if out["int8"][1] or not out["int8"][2]:
        raise AssertionError(f"[spec-parity] int8 KV: K1 {out['int8'][1]}, "
                             f"K1q {out['int8'][2]}")
    del q_pair
    int8_tie_witness(both(int8_params(cfg, SEED + 36), cfg), prompts[0])
    log(f"[spec-parity] 2 layers f32: every run identical on cuda and cpu; "
        f"speculative == non-speculative tokens on cuda; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return dict(launches_int8=out["int8"][2])


# ----------------------------------------------------------- handoff phase
@contextlib.contextmanager
def handoff_timers():
    """Host seconds spent inside paging.export_blocks (the device gather,
    the copy to the host and the hashing), inside its hashing
    (paging._hash_block) and inside paging.adopt_blocks (the upload and
    the scatter), while the block is open: each is wrapped by a timer
    and put back on exit."""
    from tf_operator_tpu_torch.models import paging

    names = ("export_blocks", "_hash_block", "adopt_blocks")
    originals = {name: getattr(paging, name) for name in names}
    spent = dict.fromkeys(names, 0.0)

    def timed(name):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return originals[name](*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0
        return wrapper

    for name in names:
        setattr(paging, name, timed(name))
    try:
        yield spent
    finally:
        for name, fn in originals.items():
            setattr(paging, name, fn)


def handoff_phase(model) -> None:
    """The serve phase's llama3_8b over one shared 1000-token prefix and
    16 suffixes of 32-256 tokens, 64 new tokens each, greedy, 8 slots:
    (a) unified under the slot scheduler, (b) prefill_only, (c) the
    decode side adopting (b)'s handoffs under the slot scheduler and (d)
    under the continuous one.  Gates: (c) and (d) give (a)'s tokens; CoW
    and prefix reuse happen; the prefix crosses the wire once; every K1
    launch is on the tensor cores.  Then export_blocks and adopt_blocks
    timed alone for one 79-block lane at llama3_8b's block shape."""
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models import paging
    from tf_operator_tpu_torch.models.serving import serve_loop

    cfg = model.cfg
    prefix = prompts_for(cfg, 1, PREFIX_LEN, PREFIX_LEN, SEED + 11)[0]
    sufs = prompts_for(cfg, 16, 32, SUFFIX_MAX, SEED + 12)
    full = [torch.cat([prefix, x]) for x in sufs]
    kw = dict(slots=8, block_size=BS, steps_per_sync=8,
              max_new_tokens=MAX_NEW, device="cuda", return_stats=True)
    calls = [0]
    hook = model.register_forward_hook(
        lambda *_: calls.__setitem__(0, calls[0] + 1))

    def run(tag, prompts, **extra):
        calls[0] = 0
        pa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with handoff_timers() as spent:
            out, stats = serve_loop(model, prompts, **kw, **extra)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if pa.launches != cfg.n_layers * calls[0] or pa.launches == 0:
            raise AssertionError(
                f"[handoff] ({tag}) K1 launched {pa.launches} times for "
                f"{calls[0]} model calls x {cfg.n_layers} layers")
        if pa.launches_mma != pa.launches:
            raise AssertionError(
                f"[handoff] ({tag}) {pa.launches_mma} of {pa.launches} K1 "
                f"calls took the tensor-core design")
        log(f"[handoff] ({tag}) wall_s={wall:.4f} model_calls={calls[0]} "
            f"kernel_launches={pa.launches} "
            f"tensor_core_launches={pa.launches_mma} "
            f"in_export_blocks_s={spent['export_blocks']:.4f} "
            f"of_it_hashing_s={spent['_hash_block']:.4f} "
            f"in_adopt_blocks_s={spent['adopt_blocks']:.4f} shares: "
            f"export/wall={spent['export_blocks'] / wall:.3f} "
            f"hashing/export="
            f"{spent['_hash_block'] / max(spent['export_blocks'], 1e-9):.3f}"
            f" adopt/wall={spent['adopt_blocks'] / wall:.3f}")
        return out, stats, wall

    uni, st_a, _ = run("a", sufs, shared_prefix=prefix)
    hand, st_b, wall_b = run("b", sufs, shared_prefix=prefix,
                             prefill_only=True)
    slot, st_c, _ = run("c", full, adopt=hand)
    cont, st_d, _ = run("d", full, adopt=hand, scheduler="continuous")
    hook.remove()

    want = [r.tokens for r in uni]
    for tag, res in (("c", slot), ("d", cont)):
        for i, (r, w) in enumerate(zip(res, want)):
            if r.tokens != w:
                raise AssertionError(
                    f"[handoff] ({tag}) request {i}: {r.tokens} != the "
                    f"unified run's {w}")
    n_shared = PREFIX_LEN // BS
    if not (st_a.cow_copies == st_b.cow_copies == len(sufs)
            and st_a.prefix_block_hits > 0 and st_c.prefix_block_hits > 0):
        raise AssertionError(
            f"[handoff] cow_copies (a) {st_a.cow_copies} (b) "
            f"{st_b.cow_copies}, prefix_block_hits (a) "
            f"{st_a.prefix_block_hits} (c) {st_c.prefix_block_hits}")
    exports = [h.export for h in hand]
    pfx_hashes = exports[0].hashes[:n_shared]
    if not (all(e.shared[:n_shared] == [True] * n_shared for e in exports)
            and all(h in exports[0].payload for h in pfx_hashes)
            and not any(h in e.payload for e in exports[1:]
                        for h in e.hashes[:n_shared])
            and all(e.hashes[:n_shared] == pfx_hashes for e in exports)):
        raise AssertionError("[handoff] the prefix's payload did not cross "
                             "the wire exactly once")
    live = sum(1 for h in hand if not h.completed)
    if not (st_b.handoff_exports == st_c.handoff_adoptions
            == st_d.handoff_adoptions == live):
        raise AssertionError(
            f"[handoff] exports {st_b.handoff_exports}, adoptions "
            f"{st_c.handoff_adoptions} / {st_d.handoff_adoptions}, "
            f"handoffs to adopt {live}")
    blocks = sum(len(e) for e in exports)
    payload = sum(e.payload_blocks() for e in exports)
    wire = sum(e.nbytes() for e in exports)
    log(f"[handoff] llama3_8b, shared prefix {PREFIX_LEN} tokens "
        f"({n_shared} shared blocks + a CoW block), {len(sufs)} suffixes "
        f"{[int(x.shape[0]) for x in sufs]}, {MAX_NEW} new tokens each, "
        f"8 slots; (c) and (d) tokens == (a) tokens for all {len(sufs)}")
    for tag, st in (("a", st_a), ("c", st_c), ("d", st_d)):
        p50, p99 = ttft_pcts(st)
        log(f"[handoff] ({tag}) tokens={st.total_tokens} "
            f"wall_s={st.wall_time_s:.4f} "
            f"tokens_per_s={st.tokens_per_sec:.2f} ttft_p50_s={p50:.4f} "
            f"ttft_p99_s={p99:.4f} prefill_s={st.prefill_time_s:.4f} "
            f"decode_s={st.decode_time_s:.4f} "
            f"cow_copies={st.cow_copies} "
            f"prefix_block_hits={st.prefix_block_hits} "
            f"handoff_adoptions={st.handoff_adoptions} "
            f"kv_blocks_peak_used={st.kv_blocks_peak_used} "
            f"preemptions={st.preemptions}")
        log(f"[handoff] ({tag}) telemetry: {tel_line(st)}")
    log(f"[handoff] (b) prefill_only wall_s={wall_b:.4f} "
        f"handoff_exports={st_b.handoff_exports} "
        f"cow_copies={st_b.cow_copies}; exported_blocks={blocks} "
        f"payload_blocks={payload} wire_bytes={wire} "
        f"({wire / 2**30:.3f} GiB; {wire / max(payload, 1)} bytes a block)")
    del uni, hand, slot, cont

    # export and adoption alone: one 79-block lane (a 1256-token prompt)
    n_blk = 79
    src = paging.init_block_pool(cfg, n_blk, BS, device="cuda")
    dst = paging.init_block_pool(cfg, n_blk, BS, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    for t in paging._leaves(src):
        t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
    ids = list(range(1, n_blk + 1))
    times = {"export_blocks": [], "_hash_block": [], "adopt_blocks": []}
    for _ in range(3):
        # the export ends in its copy to the host, a device sync
        with handoff_timers() as spent:
            exp = paging.export_blocks(src, ids, [False] * n_blk, BS)
        times["export_blocks"].append(spent["export_blocks"])
        times["_hash_block"].append(spent["_hash_block"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paging.adopt_blocks(dst, paging.BlockPool(n_blk, BS), exp)
        torch.cuda.synchronize()
        times["adopt_blocks"].append(time.perf_counter() - t0)
    for a, b in zip(paging._leaves(src), paging._leaves(dst)):
        if not torch.equal(a[1:], b[1:]):
            raise AssertionError("[handoff] adopted blocks differ from the "
                                 "exported ones")
    nbytes = exp.nbytes()
    med = {k: sorted(v)[1] for k, v in times.items()}
    share = [h / e for h, e in zip(times["_hash_block"],
                                   times["export_blocks"])]
    log(f"[handoff] export_blocks alone, {n_blk} blocks of "
        f"{nbytes // n_blk} bytes ({nbytes} bytes): "
        f"s={[round(x, 4) for x in times['export_blocks']]} median "
        f"{med['export_blocks']:.4f} s, "
        f"{nbytes / med['export_blocks'] / 1e9:.3f} GB/s; hashing inside "
        f"it s={[round(x, 4) for x in times['_hash_block']]}, share of "
        f"the export {[round(x, 3) for x in share]}")
    log(f"[handoff] adopt_blocks alone, same lane: "
        f"s={[round(x, 4) for x in times['adopt_blocks']]} median "
        f"{med['adopt_blocks']:.4f} s, "
        f"{nbytes / med['adopt_blocks'] / 1e9:.3f} GB/s")
    del src, dst, exp, model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ parity phase
def parity_phase() -> None:
    from tf_operator_tpu_torch.models import bridge, llama, paging
    from tf_operator_tpu_torch.models import paged_attention as pa
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

    # the handoff over int8 KV (K1q) and an unaligned prefix (40 % 16: a
    # CoW block): exported on the card, adopted on the card and on the
    # CPU, under both schedulers, against the CPU's unified run
    pfx = prompts_for(cfg, 1, 40, 40, SEED + 13)[0]
    sufs = prompts_for(cfg, 4, 8, 40, SEED + 14)
    full = [torch.cat([pfx, x]) for x in sufs]
    hkw = dict(slots=2, max_new_tokens=16, block_size=BS, steps_per_sync=8,
               kv_quant=True)
    want = [r.tokens for r in serve_loop(m_cpu, sufs, device="cpu",
                                         shared_prefix=pfx, **hkw)]
    pa.reset_launches()
    hand, st = serve_loop(m_gpu, sufs, device="cuda", shared_prefix=pfx,
                          prefill_only=True, return_stats=True, **hkw)
    if not (st.cow_copies == len(sufs) and pa.launches_int8 > 0
            and pa.launches == 0):
        raise AssertionError(
            f"[parity] handoff prefill: cow_copies {st.cow_copies}, K1q "
            f"launches {pa.launches_int8}, K1 launches {pa.launches}")
    if not all(h.export.payload_blocks() < len(h.export) for h in hand[1:]):
        raise AssertionError("[parity] a later export shipped the prefix "
                             "again")
    for m, dev in ((m_gpu, "cuda"), (m_cpu, "cpu")):
        for sched in ("slot", "continuous"):
            got = [r.tokens for r in serve_loop(
                m, full, device=dev, adopt=hand, scheduler=sched, **hkw)]
            if got != want:
                raise AssertionError(
                    f"[parity] handoff adopted on {dev} ({sched}): {got} "
                    f"!= the cpu's unified tokens {want}")
    log(f"[parity] handoff, int8 KV, prefix {int(pfx.shape[0])} tokens: "
        f"{len(sufs)} exports made on cuda ({st.handoff_exports} exports, "
        f"payload blocks {[h.export.payload_blocks() for h in hand]} of "
        f"{[len(h.export) for h in hand]}), adopted on cuda and cpu under "
        f"slot and continuous: tokens identical to the cpu's unified run")


# ------------------------------------------------------------ window phase
# mistral_7b's serving: a 1024-token shared prefix (64 whole blocks, two
# chunks), 16 suffixes of 1024-6656 tokens (full prompts 2048-7680), 128
# new tokens, prefill_chunk 512: a ring of bucket(4096 + 512) = 4608
# positions, 288 slots of 16
WIN_PREFIX, WIN_SUFFIX, WIN_NEW, WIN_CHUNK = 1024, (1024, 6656), 128, 512
WIN_REQUESTS = 16


@contextlib.contextmanager
def window_tally():
    """While the block is open: the shared slots the rings swapped for a
    shadow (`swaps`) and how many of those first copied the shared block
    (`copies`), counted in paging.WindowRotation.advance, and the
    BlockPool of each serve_loop call (`pools`), so a run's end state can
    be read."""
    from tf_operator_tpu_torch.models import paging

    tally = {"swaps": 0, "copies": 0, "pools": []}
    advance, pool_cls = paging.WindowRotation.advance, paging.BlockPool

    def counted(self, upto_pos, q_min):
        edits, released, evicted = advance(self, upto_pos, q_min)
        tally["swaps"] += len(edits)
        tally["copies"] += sum(c is not None for _, _, c in edits)
        return edits, released, evicted

    class Recorded(pool_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            tally["pools"].append(self)

    paging.WindowRotation.advance = counted
    paging.BlockPool = Recorded
    try:
        yield tally
    finally:
        paging.WindowRotation.advance = advance
        paging.BlockPool = pool_cls


def window_phase() -> dict:
    """mistral_7b at full width and depth (bf16, lm_head f32, random
    weights from seed 0) over a 1024-token shared prefix and 16 suffixes
    streamed through its 288-slot ring, 128 new tokens, greedy, 8 slots:
    (a) the slot scheduler, (b) the continuous one, (c) the windowed
    handoff of the first 8 requests (prefill_only under the slot
    scheduler, adopt under the continuous one).  Gates: (b) gives (a)'s
    tokens and (c) (a)'s first 8; every run's rings wrap; prefix blocks
    are shared and rotated out; each run leaves the pool holding the
    prefix's blocks alone; K1 launches equal layers x model calls, all
    on the tensor cores, and K1q is never launched."""
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop

    torch.cuda.empty_cache()
    cfg = llama.mistral_7b()
    t0 = time.perf_counter()
    model = llama.Llama.from_params(
        cfg, bridge.init_params(cfg, SEED, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    log(f"[window] mistral_7b {cfg.n_layers} layers d_model={cfg.d_model} "
        f"vocab={cfg.vocab_size} window={cfg.sliding_window} {cfg.dtype}: "
        f"random weights in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    prefix = prompts_for(cfg, 1, WIN_PREFIX, WIN_PREFIX, SEED + 21)[0]
    sufs = prompts_for(cfg, WIN_REQUESTS, *WIN_SUFFIX, SEED + 22)
    full = [torch.cat([prefix, x]) for x in sufs]
    n_pfx = WIN_PREFIX // BS
    kw = dict(slots=8, block_size=BS, steps_per_sync=8,
              prefill_chunk=WIN_CHUNK, max_new_tokens=WIN_NEW,
              device="cuda", return_stats=True)
    # warm-up: one request that streams past the ring and wraps
    serve_loop(model, [full[0][:4700]], **dict(kw, max_new_tokens=8,
                                               slots=1))
    calls = [0]
    hook = model.register_forward_hook(
        lambda *_: calls.__setitem__(0, calls[0] + 1))
    launches = []

    def run(tag, prompts, pool_left, **extra):
        calls[0] = 0
        pa.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with window_tally() as tally, handoff_timers() as spent:
            out, stats = serve_loop(model, prompts, **kw, **extra)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if pa.launches != cfg.n_layers * calls[0] or pa.launches == 0:
            raise AssertionError(
                f"[window] ({tag}) K1 launched {pa.launches} times for "
                f"{calls[0]} model calls x {cfg.n_layers} layers")
        if pa.launches_mma != pa.launches or pa.launches_int8:
            raise AssertionError(
                f"[window] ({tag}) {pa.launches_mma} of {pa.launches} K1 "
                f"calls on the tensor cores, K1q {pa.launches_int8}")
        if stats.window_evicted_blocks == 0 or tally["swaps"] == 0:
            raise AssertionError(
                f"[window] ({tag}) the rings did not wrap onto the prefix: "
                f"{stats.window_evicted_blocks} evictions, "
                f"{tally['swaps']} shared slots swapped")
        launches.append(pa.launches)
        [pool] = tally["pools"]
        if pool.used != pool_left:
            raise AssertionError(
                f"[window] ({tag}) the pool holds {pool.used} blocks after "
                f"the run, not {pool_left}")
        log(f"[window] ({tag}) wall_s={wall:.4f} model_calls={calls[0]} "
            f"kernel_launches={pa.launches} "
            f"tensor_core_launches={pa.launches_mma} "
            f"window_evicted_blocks={stats.window_evicted_blocks} "
            f"shared_slots_swapped={tally['swaps']} "
            f"rotation_copies={tally['copies']} "
            f"kv_blocks_total={stats.kv_blocks_total} "
            f"kv_blocks_peak_used={stats.kv_blocks_peak_used} "
            f"prefix_block_hits={stats.prefix_block_hits} "
            f"cow_copies={stats.cow_copies} "
            f"in_export_blocks_s={spent['export_blocks']:.4f} "
            f"of_it_hashing_s={spent['_hash_block']:.4f} "
            f"in_adopt_blocks_s={spent['adopt_blocks']:.4f} "
            f"max_memory_allocated_gib={peak / 2**30:.3f}")
        return out, stats

    uni, st_a = run("a", sufs, n_pfx, shared_prefix=prefix)
    cont, st_b = run("b", sufs, n_pfx, shared_prefix=prefix,
                     scheduler="continuous")
    hand, st_p = run("c prefill", sufs[:8], n_pfx, shared_prefix=prefix,
                     prefill_only=True)
    dec, st_c = run("c decode", full[:8], 0, adopt=hand,
                    scheduler="continuous")
    hook.remove()
    want = [r.tokens for r in uni]
    for tag, res in (("b", cont), ("c", dec)):
        for i, r in enumerate(res):
            if r.tokens != want[i]:
                raise AssertionError(
                    f"[window] ({tag}) request {i}: {r.tokens} != (a)'s "
                    f"{want[i]}")
    for i, r in enumerate(uni):
        if len(r.tokens) != WIN_NEW or not all(0 <= t < cfg.vocab_size
                                               for t in r.tokens):
            raise AssertionError(f"[window] request {i}: {len(r.tokens)} "
                                 f"tokens or one out of vocab")
    if not (st_a.prefix_block_hits == st_b.prefix_block_hits
            == n_pfx * WIN_REQUESTS and st_c.prefix_block_hits > 0):
        raise AssertionError(
            f"[window] prefix_block_hits (a) {st_a.prefix_block_hits} (b) "
            f"{st_b.prefix_block_hits} (c) {st_c.prefix_block_hits}")
    wins = [h.export.window for h in hand]
    if not all(w["ring"] == 288 for w in wins):
        raise AssertionError(f"[window] rings {[w['ring'] for w in wins]}")
    log(f"[window] mistral_7b, shared prefix {WIN_PREFIX} tokens "
        f"({n_pfx} shared blocks), {WIN_REQUESTS} suffixes, full prompts "
        f"{[int(x.shape[0]) for x in full]}, {WIN_NEW} new tokens each, "
        f"8 slots, prefill_chunk {WIN_CHUNK}, ring {wins[0]['ring']} slots "
        f"of {BS}: (b) tokens == (a) tokens for all {WIN_REQUESTS}, (c) "
        f"== (a) for its 8")
    for tag, st in (("a", st_a), ("b", st_b), ("c decode", st_c)):
        p50, p99 = ttft_pcts(st)
        log(f"[window] ({tag}) tokens={st.total_tokens} "
            f"wall_s={st.wall_time_s:.4f} "
            f"tokens_per_s={st.tokens_per_sec:.2f} ttft_p50_s={p50:.4f} "
            f"ttft_p99_s={p99:.4f} prefill_s={st.prefill_time_s:.4f} "
            f"decode_s={st.decode_time_s:.4f} "
            f"fused_prefill_tokens={st.fused_prefill_tokens} "
            f"handoff_adoptions={st.handoff_adoptions}")
        log(f"[window] ({tag}) telemetry: {tel_line(st)}")
    log(f"[window] (c prefill) handoff_exports={st_p.handoff_exports} "
        f"exported_blocks={sum(len(h.export) for h in hand)} "
        f"payload_blocks={sum(h.export.payload_blocks() for h in hand)} "
        f"wire_bytes={sum(h.export.nbytes() for h in hand)} next_block="
        f"{[w['next_block'] for w in wins]} shared_slots_left="
        f"{[len(w['shared_slots']) for w in wins]}")
    log(f"[window] K1 launches per run (a, b, c prefill, c decode): "
        f"{launches}, {sum(launches)} in all")
    del uni, cont, hand, dec, model
    torch.cuda.empty_cache()
    return dict(launches=sum(launches))


# ----------------------------------------------------- window-parity phase
def window_parity_phase() -> dict:
    """mistral_7b at full width, 2 layers, f32 (TF32 off), window 64 and
    max_len 512 so the ring (128 positions) wraps at lengths the CPU can
    serve: greedy tokens and schedule on the card (K1) equal the CPU's
    (plain) for prompts streaming past the ring over a shared prefix,
    under both schedulers; over an unaligned prefix and window 120 (the
    rotation copies shared blocks, the boundary is copied on write); with
    int8 KV (K1q); and a windowed int8-KV handoff exported on the card and
    adopted on the card and on the CPU gives the CPU's unified tokens."""
    import dataclasses

    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama.mistral_7b(n_layers=2, sliding_window=64, max_len=512,
                           dtype=torch.float32)
    cfg120 = dataclasses.replace(cfg, sliding_window=120)
    params = bridge.init_params(cfg, SEED + 23, device="cuda")
    cpu_params = {k: v.cpu() for k, v in params.items()}
    models = {(w, dev): llama.Llama.from_params(c, p, device=dev)
              for w, c in ((64, cfg), (120, cfg120))
              for dev, p in (("cuda", params), ("cpu", cpu_params))}
    del params, cpu_params
    sched = lambda rs: [(r.tokens, r.admitted_at_step, r.finished_at_step,
                         r.slot, r.kv_blocks) for r in rs]
    pfx = prompts_for(cfg, 1, 32, 32, SEED + 24)[0]
    sufs = prompts_for(cfg, 4, 110, 200, SEED + 25)
    base = dict(slots=2, block_size=BS, steps_per_sync=8,
                return_stats=True)
    runs = {
        # prompts of 142-232 tokens stream past the 128-position ring in
        # chunks of 32 (<= ring - window) over a 32-token prefix
        "stream": (64, sufs, dict(base, max_new_tokens=24, prefill_chunk=32,
                                  shared_prefix=pfx)),
        # a 40-token prefix (2 whole blocks and a CoW block), unchunked,
        # window 120: each decode wrap onto a prefix slot copies it first
        "copy": (120, prompts_for(cfg, 4, 50, 80, SEED + 26),
                 dict(base, max_new_tokens=40,
                      shared_prefix=prompts_for(cfg, 1, 40, 40,
                                                SEED + 27)[0])),
        "int8": (64, sufs, dict(base, max_new_tokens=24, prefill_chunk=32,
                                shared_prefix=pfx, kv_quant=True)),
    }
    out = {"launches_int8": 0}
    for name, (w, reqs, kw) in runs.items():
        with window_tally() as tally:
            want, st_cpu = serve_loop(models[w, "cpu"], reqs, device="cpu",
                                      **kw)
        copies_cpu = tally["copies"]
        for scheduler in ("slot", "continuous"):
            pa.reset_launches()
            with window_tally() as tally:
                got, st = serve_loop(models[w, "cuda"], reqs, device="cuda",
                                     scheduler=scheduler, **kw)
            int8 = kw.get("kv_quant", False)
            if (pa.launches_int8 if int8 else pa.launches) == 0 or (
                    pa.launches if int8 else pa.launches_int8):
                raise AssertionError(
                    f"[window-parity] ({name}, {scheduler}) K1 "
                    f"{pa.launches}, K1q {pa.launches_int8} launches")
            if int8:
                out["launches_int8"] += pa.launches_int8
            same = (sched(got) == sched(want) if scheduler == "slot"
                    else [r.tokens for r in got] == [r.tokens for r in want])
            if not same:
                raise AssertionError(
                    f"[window-parity] ({name}, {scheduler}) cuda "
                    f"{sched(got)} != cpu {sched(want)}")
            if st.window_evicted_blocks == 0 or (
                    name == "copy" and (tally["copies"] == 0
                                        or st.cow_copies == 0)):
                raise AssertionError(
                    f"[window-parity] ({name}, {scheduler}) evictions "
                    f"{st.window_evicted_blocks}, rotation copies "
                    f"{tally['copies']}, cow copies {st.cow_copies}")
            log(f"[window-parity] ({name}, {scheduler}) {len(reqs)} "
                f"requests, cuda's "
                f"{'tokens and schedule' if scheduler == 'slot' else 'tokens'}"
                f" == cpu's (slot); "
                f"window_evicted_blocks={st.window_evicted_blocks} "
                f"rotation_copies={tally['copies']} (cpu {copies_cpu}) "
                f"cow_copies={st.cow_copies} "
                f"prefix_block_hits={st.prefix_block_hits} "
                f"K1={pa.launches} K1q={pa.launches_int8}")
        if name == "int8":
            unified = [r.tokens for r in want]
    # the windowed handoff, int8 KV: exported on the card, adopted on
    # the card (both schedulers) and on the CPU
    kw = dict(runs["int8"][2])
    full = [torch.cat([pfx, x]) for x in sufs]
    hand, st = serve_loop(models[64, "cuda"], sufs, device="cuda",
                          prefill_only=True, **kw)
    if not all(h.export.window["ring"] == 8 for h in hand):
        raise AssertionError("[window-parity] the exports carry no ring")
    del kw["shared_prefix"]
    for dev in ("cuda", "cpu"):
        for scheduler in ("slot", "continuous"):
            got, _ = serve_loop(models[64, dev], full, device=dev,
                                adopt=hand, scheduler=scheduler, **kw)
            if [r.tokens for r in got] != unified:
                raise AssertionError(
                    f"[window-parity] handoff adopted on {dev} "
                    f"({scheduler}): {[r.tokens for r in got]} != the "
                    f"cpu's unified {unified}")
    log(f"[window-parity] windowed handoff, int8 KV: {len(hand)} exports "
        f"made on cuda (next_block "
        f"{[h.export.window['next_block'] for h in hand]}, payload blocks "
        f"{[h.export.payload_blocks() for h in hand]} of "
        f"{[len(h.export) for h in hand]}), adopted on cuda and cpu under "
        f"slot and continuous: tokens identical to the cpu's unified run")
    del models
    torch.cuda.empty_cache()
    return out


# --------------------------------------------- window kernel shapes (K1/K1q)
WIN_W, WIN_SLOTS = 4096, 288


def window_case(l: int, seed: int, dtype=torch.bfloat16) -> dict:
    """The window phase's kernel shapes: at L=1, 8 lanes over wrapped
    288-slot rings of 16-position blocks (contexts 4609 to 7815, the
    phase's full prompts plus their decode); at L=512, one lane's segment
    at positions 5120-5631, streamed past the ring.  Window 4096; the
    scratch block is poisoned."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if l == 1:
        ctx = [4609, 7815] + torch.randint(4610, 7815, (6,),
                                           generator=g).tolist()
    else:
        ctx = [5120 + l]
    b = len(ctx)
    dev = torch.device("cuda")
    table = (torch.randperm(b * WIN_SLOTS, generator=g) + 1).to(
        torch.int32).view(b, WIN_SLOTS)
    shape = (b * WIN_SLOTS + 1, BS, KV, D)
    k_pool = torch.randn(shape, generator=g)
    v_pool = torch.randn(shape, generator=g)
    k_pool[0] = 1e4
    v_pool[0] = 1e4
    q = torch.randn((b, l, H, D), generator=g)
    return dict(q=q.to(dev, dtype), k=k_pool.to(dev, dtype),
                v=v_pool.to(dev, dtype), table=table.to(dev),
                pos=torch.tensor([c - l for c in ctx], dtype=torch.int32,
                                 device=dev), window=WIN_W, ctx=ctx)


def window_bound_ms(case, dtype, int8: bool = False) -> tuple:
    """bound_ms for a window case, counting only the keys inside the
    window: a lane's L rows at pos..pos+L-1 read the positions
    pos+L-window .. pos+L-1 (each once) and row i does its products
    against min(pos+i+1, window) of them."""
    esz = torch.finfo(dtype).bits // 8
    q = case["q"]
    b, l, h, d = q.shape
    per_pos = KV * D * esz if not int8 else KV * D + KV * 4
    keys = pairs = 0
    for p in case["pos"].tolist():
        keys += (p + l) - max(0, p + l - WIN_W)
        pairs += sum(min(p + i + 1, WIN_W) for i in range(l))
    io = 2 * q.numel() * esz + case["table"].numel() * 4 + b * 4
    t_bytes = (keys * per_pos * 2 + io) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * 2 * h * d * pairs / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def window_kernel_phase(int8: bool = False) -> dict:
    """K1 (or K1q over int8_pools of the same draws) at the window
    phase's shapes against its plain version, bf16 and f32 queries: live
    rows within PAGED_TOL, two launches with the same bits; then the bf16
    decode and prefill times beside the plain version, SDPA over the
    gathered view with the ring and window mask, and the bound."""
    from tf_operator_tpu_torch.models import paged_attention as pa

    tag = "[kernel1q-window]" if int8 else "[kernel-window]"
    plain = (pa.paged_attention_int8_plain if int8
             else pa.paged_attention_plain)

    def inputs(case):
        k, v = int8_pools(case) if int8 else (case["k"], case["v"])
        return (case["q"], k, v, case["table"], case["pos"])

    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    timings = {}
    for name, l in (("decode", 1), ("prefill", 512)):
        for dt in (torch.float32, torch.bfloat16):
            case = window_case(l, SEED + 200 + l, dt)
            args = inputs(case)
            errs[dt] = max(errs[dt], check_paged(
                case, args, plain, dt, None,
                f"{tag} {str(dt)[6:]:8s} {name} L={l} "
                f"B={len(case['ctx'])} ring {WIN_SLOTS} slots window "
                f"{WIN_W} ctx={case['ctx']}"))
        timings[name] = paged_timing(
            case, args, plain, window_bound_ms(case, torch.bfloat16, int8),
            f"{tag} timing {name} bf16 q, {'int8' if int8 else 'bf16'} KV, "
            f"B={len(case['ctx'])} L={l} ring {WIN_SLOTS} x {BS} window "
            f"{WIN_W} ctx={case['ctx']}")
    return dict(errs=errs, timings=timings)


# -------------------------------------------------------------- train phase
TRAIN_STEPS = 4


def train_model(cfg):
    """The model train_llama builds for `cfg`, around f32 masters drawn
    from SEED, and its train state and step."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.runtime.optim import Adafactor
    from tf_operator_tpu_torch.runtime.train import TrainState

    model = llama.Llama.from_params(
        cfg, bridge.init_params(cfg, SEED, device="cuda", train=True),
        device="cuda", train=True)
    state = TrainState.create(model, Adafactor(1e-3))
    return model, state, train_llama.make_lm_step(model)


def llama3_train_cfg(**kw):
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.ops.flash_attention import flash_attention

    kw.setdefault("attention_fn", flash_attention)
    return llama.llama3_8b(tie_embeddings=True, remat=True, **kw)


def train_phase() -> dict:
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models.llama import params_flops_per_token
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.runtime.loop import run_training
    from tf_operator_tpu_torch.runtime.profiler import Profiler

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama3_train_cfg()
    t0 = time.perf_counter()
    model, state, step = train_model(cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] llama3_8b tied, remat, flash attention, {cfg.n_layers} "
        f"layers, {n_params / 1e9:.4f} B f32 master params in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB); compute "
        f"{cfg.dtype}; batch {TB} x {TS}")
    losses, times = [], []

    def timed_step(state, tokens):
        t = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return state, metrics

    batches = train_llama.lm_batches(TB, TS, cfg.vocab_size, SEED + 4,
                                     device="cuda")
    fa.reset_launches()
    res = run_training(state, timed_step, batches, num_steps=TRAIN_STEPS,
                       profiler=Profiler(batch_size=TB), log_interval_steps=1,
                       metrics_sink=lambda line: log(f"[train] metrics {line}"))
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    del model, state, step, res
    torch.cuda.empty_cache()

    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[train] losses {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.5:
        raise AssertionError(f"[train] first loss {losses[0]} is not within "
                             f"1.5 of ln({cfg.vocab_size})")
    # bf16 compute: every launch takes a tensor-core kernel
    want = {"flash_fwd": 2 * cfg.n_layers * TRAIN_STEPS,
            "flash_fwd_mma": 2 * cfg.n_layers * TRAIN_STEPS,
            "flash_dq": cfg.n_layers * TRAIN_STEPS,
            "flash_dq_mma": cfg.n_layers * TRAIN_STEPS,
            "flash_dkv": cfg.n_layers * TRAIN_STEPS,
            "flash_dkv_mma": cfg.n_layers * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"[train] kernel launches {launches}, "
                             f"expected {want}")
    steady = sorted(times[1:])
    step_s = steady[len(steady) // 2]
    tokens_per_s = TB * TS / step_s
    mfu = tokens_per_s * params_flops_per_token(cfg) / PEAK_OPS_PER_S[
        torch.bfloat16]
    log(f"[train] losses {[round(x, 4) for x in losses]} "
        f"(ln V = {math.log(cfg.vocab_size):.4f}); step_s "
        f"{[round(x, 4) for x in times]}; steady step_s (median of steps "
        f"2-{TRAIN_STEPS}) {step_s:.4f}, tokens_per_s {tokens_per_s:.2f}, "
        f"mfu {mfu:.4f}, max_memory_allocated_gib {peak / 2**30:.3f}, "
        f"kernel_launches {json.dumps(launches)}")
    return dict(launches=launches, losses=losses)


# K2 launches of one f32 step of 2 layers with remat: the scalar kernels
F32_K2_LAUNCHES = {"flash_fwd": 4, "flash_fwd_mma": 0, "flash_dq": 2,
                   "flash_dq_mma": 0, "flash_dkv": 2, "flash_dkv_mma": 0}


def train_parity_phase() -> None:
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops.blocked_ce import lm_blocked_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama3_train_cfg(n_layers=2, dtype=torch.float32)
    params = bridge.init_params(cfg, SEED + 5, device="cuda", train=True)
    models = {"cuda": llama.Llama.from_params(cfg, params, device="cuda",
                                              train=True),
              "cpu": llama.Llama.from_params(
                  cfg, {k: v.cpu() for k, v in params.items()},
                  device="cpu", train=True)}
    del params
    g = torch.Generator(device="cpu").manual_seed(SEED + 6)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=g)
    fa.reset_launches()
    out = {}
    for dev, model in models.items():
        loss = lm_blocked_loss(model, tokens.to(dev))
        loss.backward()
        # norms in f64: torch's f32 norm of a 117M-element tensor on the
        # CPU is off by 1.6 % (measured on blocks.1.mlp.wi), the card's
        # by 1e-8
        out[dev] = (loss.item(), {
            k: torch.linalg.vector_norm(p.grad, dtype=torch.float64).item()
            for k, p in model.named_parameters()})
    launches = dict(fa.launches)
    del models
    torch.cuda.empty_cache()
    (l_gpu, n_gpu), (l_cpu, n_cpu) = out["cuda"], out["cpu"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    norm_rel = {k: abs(n_gpu[k] - n_cpu[k]) / max(n_cpu[k], 1e-30)
                for k in n_cpu}
    worst = max(norm_rel, key=norm_rel.get)
    log(f"[train-parity] 2 layers f32, batch 2 x 128: loss cuda {l_gpu:.7f} "
        f"cpu {l_cpu:.7f} (rel {loss_rel:.2e}, limit 1e-5); "
        f"{len(norm_rel)} gradient norms, worst rel {norm_rel[worst]:.2e} "
        f"({worst}, limit 1e-4); launches {json.dumps(launches)}")
    if not (math.isfinite(l_gpu) and loss_rel <= 1e-5
            and norm_rel[worst] <= 1e-4):
        raise AssertionError("[train-parity] the card and the CPU disagree")
    # f32: the scalar kernels, never the tensor cores (TF32)
    if launches != F32_K2_LAUNCHES:
        raise AssertionError(f"[train-parity] launches {launches}")


# ------------------------------------------------------- serve-int8 phase
# blocks of the serve-int8 pool: the slot loop's default for the serve
# phase's requests is 8 lanes x 65 blocks = 520; at 240 the continuous
# scheduler's step gate blocks and growth preempts
INT8_POOL = 240


def int8_params(cfg, seed: int):
    """int8 weights on the card, quantized from the f32 draws of `seed`
    (bridge.init_params(train=True)); the f32 tree is freed here."""
    from tf_operator_tpu_torch.models import bridge, quant

    master = bridge.init_params(cfg, seed, device="cuda", train=True)
    params = quant.quantize_params(master)
    del master
    return params


def serve_int8_phase() -> dict:
    from tf_operator_tpu_torch.models import llama, quant
    from tf_operator_tpu_torch.models import paged_attention as pa
    from tf_operator_tpu_torch.models.serving import serve_loop

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama.llama3_8b()
    t0 = time.perf_counter()
    params = int8_params(cfg, SEED)
    qbytes = quant.quantized_bytes(params)
    model = llama.Llama.from_params(cfg, params, device="cuda")
    del params
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    log(f"[serve-int8] llama3_8b {cfg.n_layers} layers, int8 weights "
        f"quantized from the f32 draws of seed {SEED} in "
        f"{time.perf_counter() - t0:.1f} s (peak while quantizing "
        f"{build_peak / 2**30:.3f} GiB); quantized_bytes {qbytes} "
        f"({qbytes / 2**30:.3f} GiB), resident "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB; compute "
        f"{cfg.dtype}")
    kw = dict(slots=8, block_size=BS, steps_per_sync=8, device="cuda",
              scheduler="continuous", kv_quant=True, prefill_chunk=256,
              prefill_chunks_per_sync=1)
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
                                pool_blocks=INT8_POOL, return_stats=True,
                                **kw)
    torch.cuda.synchronize()
    launches, k1_launches = pa.launches_int8, pa.launches
    mma = pa.launches_int8_mma
    hook.remove()
    peak = torch.cuda.max_memory_allocated()

    for i, r in enumerate(results):
        if len(r.tokens) != MAX_NEW:
            raise AssertionError(f"[serve-int8] request {i} emitted "
                                 f"{len(r.tokens)} tokens, budget {MAX_NEW}")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"[serve-int8] request {i}: token out of "
                                 f"vocab")
    if launches != cfg.n_layers * calls[0] or launches == 0 or k1_launches:
        raise AssertionError(
            f"[serve-int8] K1q launched {launches} times and K1 "
            f"{k1_launches} times for {calls[0]} model calls x "
            f"{cfg.n_layers} layers")
    if mma != launches:
        raise AssertionError(f"[serve-int8] {mma} of {launches} bf16-query "
                             f"K1q calls took the tensor-core design")
    if not (stats.fused_prefill_tokens > 0
            and stats.admissions_blocked_on_memory > 0
            and stats.kv_blocks_peak_used <= INT8_POOL):
        raise AssertionError(f"[serve-int8] the continuous scheduler did not "
                             f"fuse, gate and bound as planned: {stats}")
    ttft = sorted(r["ttft_s"] for r in stats.per_request)
    pct = lambda p: ttft[min(len(ttft) - 1, math.ceil(p * len(ttft)) - 1)]
    e2e = [r["e2e_latency_s"] for r in stats.per_request]
    log(f"[serve-int8] {len(results)} requests, {MAX_NEW} new tokens each, "
        f"scheduler continuous, prefill_chunk 256 one segment a turn, pool "
        f"{INT8_POOL} blocks of {BS}")
    log(f"[serve-int8] tokens={stats.total_tokens} "
        f"wall_s={stats.wall_time_s:.4f} "
        f"tokens_per_s={stats.tokens_per_sec:.2f} "
        f"ttft_p50_s={pct(0.5):.4f} ttft_p99_s={pct(0.99):.4f} "
        f"e2e_max_s={max(e2e):.4f} prefill_s={stats.prefill_time_s:.4f} "
        f"decode_s={stats.decode_time_s:.4f} "
        f"fused_prefill_tokens={stats.fused_prefill_tokens} "
        f"preemptions={stats.preemptions} "
        f"admissions_blocked_on_memory={stats.admissions_blocked_on_memory} "
        f"kv_blocks_peak_used={stats.kv_blocks_peak_used} "
        f"model_calls={calls[0]} k1q_launches={launches} "
        f"k1q_tensor_core_launches={mma} "
        f"k1_launches={k1_launches} quantized_bytes={qbytes} "
        f"max_memory_allocated_gib={peak / 2**30:.3f}")
    log(f"[serve-int8] telemetry: {tel_line(stats)}")
    del model
    torch.cuda.empty_cache()
    return dict(launches=launches)


# ------------------------------------------------------ parity-int8 phase
def parity_int8_phase() -> None:
    from tf_operator_tpu_torch.models import llama
    from tf_operator_tpu_torch.models.serving import serve_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama.llama3_8b(n_layers=2, dtype=torch.float32)
    params = int8_params(cfg, SEED + 7)
    m_gpu = llama.Llama.from_params(cfg, params, device="cuda")
    m_cpu = llama.Llama.from_params(
        cfg, {k: v.to("cpu") for k, v in params.items()}, device="cpu")
    del params
    prompts = prompts_for(cfg, 4, 24, 96, SEED + 3)
    # staggered budgets: a newcomer's segments ride a neighbour's decode
    kw = dict(slots=2, max_new_tokens=[6, 16, 10, 12], block_size=BS,
              steps_per_sync=8, prefill_chunk=32, kv_quant=True)
    sched = lambda rs: [(r.tokens, r.admitted_at_step, r.finished_at_step,
                         r.slot, r.kv_blocks) for r in rs]
    got, stats = serve_loop(m_gpu, prompts, device="cuda",
                            scheduler="continuous", return_stats=True, **kw)
    want = serve_loop(m_cpu, prompts, device="cpu", scheduler="continuous",
                      **kw)
    slot = serve_loop(m_gpu, prompts, device="cuda", scheduler="slot", **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        log(f"[parity-int8] request {i}: cuda {g.tokens}")
    if sched(got) != sched(want):
        raise AssertionError(f"[parity-int8] cuda {sched(got)} != cpu "
                             f"{sched(want)}")
    if [r.tokens for r in got] != [r.tokens for r in slot]:
        raise AssertionError("[parity-int8] continuous tokens differ from "
                             "slot tokens on the card")
    if stats.fused_prefill_tokens == 0:
        raise AssertionError("[parity-int8] no segment was fused")
    log(f"[parity-int8] 2 layers f32, int8 weights and KV: {len(prompts)} "
        f"requests, greedy tokens and schedule identical on cuda and cpu "
        f"(continuous, {stats.fused_prefill_tokens} fused prefill tokens), "
        f"and continuous == slot on cuda")
    del m_gpu, m_cpu
    torch.cuda.empty_cache()



# --------------------------------------------------------- kernel-3 phase
# the ring of the ring-train phase: llama3_8b's 2048 training positions
# over 4 members
RING_N, RING_SL = 4, TS // 4
RING = ("ring_fwd", "ring_dq", "ring_dkv")


def ring_case(dtype, s_l: int, seed: int, carry: str):
    """One (member, step) of the ring at the training widths: q and dO
    [B, S_l, H, D], k and v as the halves of a fused [B, S_l, 2, KV, D]
    projection, the forward carry (m, l [B, H, S_l], acc [B, S_l, H, D]:
    "fresh" as the ring starts it, "mid" as after earlier steps, "masked"
    with a third of the rows having seen no key), and lse, delta for the
    backward with a few rows at lse = POS_INF.  This lse stands for the
    mass of the ring's other steps only; `forward_lse` adds the step's
    own, as the forward pass does."""
    from tf_operator_tpu_torch.ops import ring_flash as rf

    g = torch.Generator(device="cpu").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g)
    q, do = rn(TB, s_l, TH, TD), rn(TB, s_l, TH, TD)
    kv = rn(TB, s_l, 2, TKV, TD)
    m, l, acc = rn(TB, TH, s_l), rn(TB, TH, s_l).abs() + 1, rn(TB, s_l, TH, TD)
    if carry == "fresh":
        m.fill_(rf.NEG_INF)
        l.zero_()
        acc.zero_()
    if carry == "masked":
        m[:, :, :s_l // 3] = rf.NEG_INF
        l[:, :, :s_l // 3] = 0.0
        acc[:, :s_l // 3] = 0.0
    lse, delta = rn(TB, TH, s_l) + 3, rn(TB, TH, s_l)
    lse[:, 0, :8] = rf.POS_INF
    q, do, kv = (t.to("cuda", dtype) for t in (q, do, kv))
    state = [t.cuda() for t in (m, l, acc, lse, delta)]
    return (q, kv[:, :, 0], kv[:, :, 1], do), state


def forward_lse(lse, q, steps, q_off, window=None):
    """lse as the ring's forward leaves it for these steps ((k, k_off)
    pairs): the logsumexp of each row's scaled visible scores over them,
    added to `lse` (the other steps' mass; POS_INF rows stay POS_INF).
    So p = exp(s - lse) <= 1, as in every real backward step."""
    from tf_operator_tpu_torch.ops import ring_flash as rf

    b, s_l, h, _ = q.shape
    terms = [lse]
    for k, k_off in steps:
        sc = rf._scores(q, k, rf._mask(q_off, k_off, s_l, True, window,
                                       q.device))
        terms.append(torch.logsumexp(sc, dim=-1).reshape(b, h, s_l))
    return torch.logsumexp(torch.stack(terms), dim=0)


def ring_launch_bound(which: str, dtype, s_l: int, pairs: int) -> tuple:
    """(bytes, flops) of one K3 launch over `pairs` visible (query, key)
    pairs: each input read once and each output written once, the f32
    carry or accumulators both read and written (they are updated in
    place); products 2 flops per multiply-add for 2 matmuls (forward:
    QKᵀ, PV), 3 (dQ: QKᵀ, dO·Vᵀ, dS·K) or 4 (dK/dV: QKᵀ, dO·Vᵀ, Pᵀ·dO,
    dSᵀ·Q)."""
    esz = torch.finfo(dtype).bits // 8
    qo = TB * s_l * TH * TD * esz
    kv = TB * s_l * TKV * TD * esz
    stat = TB * TH * s_l * 4
    acc_q = TB * s_l * TH * TD * 4
    acc_kv = TB * s_l * TKV * TD * 4
    nbytes = {"ring_fwd": qo + 2 * kv + 4 * stat + 2 * acc_q,
              "ring_dq": 2 * qo + 2 * kv + 2 * stat + 2 * acc_q,
              "ring_dkv": 2 * qo + 2 * kv + 2 * stat + 4 * acc_kv}[which]
    mm = {"ring_fwd": 2, "ring_dq": 3, "ring_dkv": 4}[which]
    return nbytes, mm * 2 * TB * TH * pairs * TD


def bound_of(launches: list, dtype) -> tuple:
    """The least time for a list of (bytes, flops): the larger of all the
    bytes over HBM bandwidth and all the products over the peak."""
    t_bytes = sum(b for b, _ in launches) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(f for _, f in launches) / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def visible_pairs(q_off, k_off, s_l: int, window=None) -> int:
    from tf_operator_tpu_torch.ops import ring_flash as rf

    return int(rf._mask(q_off, k_off, s_l, True, window, "cpu").sum())


def kernel3_phase() -> dict:
    """K3f, K3q and K3kv against their plain versions on one (member,
    step) each of the cases below, bf16 and f32; two launches must give
    the same bits, a dead step must leave every accumulator as it was,
    and every bf16 K3f, K3q and K3kv launch must run on the tensor cores
    (no f32 one).  Then, in bf16, the last member's launches over its
    ring (3 past steps and its diagonal: the most work of any member)
    timed beside the same plain calls, their bound, and SDPA of that
    member's q against the whole sequence's k/v under the global causal
    mask (forward, and backward through autograd)."""
    from tf_operator_tpu_torch.ops import ring_flash as rf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # f32: 64-wide tiles folded by online softmax against whole-shard
    # einsums (~1e-6 on O(1) values).  bf16: p and dS rounded to bf16
    # (2^-8 relative), at a running instead of the final maximum.  The
    # forward's acc is an unnormalized sum of up to S_l terms p·v, so its
    # rounding error grows with l: it is held as acc / l, the output the
    # finish step forms (l == 0 -> 1), beside m and l themselves.
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

    def as_out(m, l, acc):
        l_safe = torch.where(l == 0.0, 1.0, l)
        return m, l, acc / l_safe.transpose(1, 2)[..., None]

    errs = {name: 0.0 for name in RING}
    # (S_l, layout, member, resident shard's member, window, carry)
    cases = [(RING_SL, "contiguous", 2, 2, None, "fresh"),
             (RING_SL, "contiguous", 2, 1, None, "mid"),
             (RING_SL, "contiguous", 1, 2, None, "mid"),
             (RING_SL, "zigzag", 1, 2, None, "mid"),
             (RING_SL, "zigzag", 2, 2, None, "fresh"),
             (RING_SL, "contiguous", 3, 2, 512, "mid"),
             (RING_SL, "contiguous", 3, 3, None, "masked"),
             (200, "zigzag", 1, 3, None, "mid")]
    for i, (s_l, layout, my, src, w, carry) in enumerate(cases):
        for dt in (torch.bfloat16, torch.float32):
            (q, k, v, do), (m, l, acc, lse, delta) = ring_case(
                dt, s_l, SEED + 40 + i, carry)
            offs = (rf.offsets(my, RING_N, s_l, layout),
                    rf.offsets(src, RING_N, s_l, layout), True, w)
            lse_other = lse
            lse = forward_lse(lse_other, q, [(k, offs[1])], offs[0], w)
            bwd = (q, k, v, do, lse, delta)
            want = {"ring_fwd": as_out(*rf.carry_fwd_plain(q, k, v, m, l,
                                                           acc, *offs)),
                    "ring_dq": (rf.ring_dq_plain(*bwd, *offs),),
                    "ring_dkv": rf.ring_dkv_plain(*bwd, *offs)}
            runs = []
            before = dict(rf.launches)
            for _ in range(2):
                st = [t.clone() for t in (m, l, acc)]
                rf.ring_fwd(q, k, v, *st, *offs)
                dq = torch.zeros(q.shape, device="cuda")
                dk = torch.zeros(k.shape, device="cuda")
                dv = torch.zeros(k.shape, device="cuda")
                rf.ring_dq(*bwd, dq, *offs)
                rf.ring_dkv(*bwd, dk, dv, *offs)
                runs.append({"ring_fwd": st, "ring_dq": (dq,),
                             "ring_dkv": (dk, dv)})
            torch.cuda.synchronize()
            counts = {n: rf.launches[n] - before[n] for n in rf.launches}
            mma = {f"{n}_mma": counts[f"{n}_mma"] for n in RING}
            if any(counts[n] != 2 for n in RING) or mma != {
                    f"{n}_mma": counts[n] if dt == torch.bfloat16 else 0
                    for n in RING}:
                raise AssertionError(f"[kernel3] {dt} launches {counts}: 2 "
                                     f"of each, all on the tensor cores in "
                                     f"bf16, none in f32")
            dead = src > my and layout == "contiguous"
            line = []
            for name in RING:
                same = all(torch.equal(a, b)
                           for a, b in zip(runs[0][name], runs[1][name]))
                err, ok = 0.0, same
                got_all = runs[0][name]
                if name == "ring_fwd":
                    got_all = as_out(*got_all)
                for got, ref in zip(got_all, want[name]):
                    diff = (got - ref).abs()
                    err = max(err, float(diff.max()))
                    ok &= bool(torch.isfinite(got).all())
                    ok &= bool((diff <= tol[dt] * (1 + ref.abs())).all())
                if dead:
                    # a dead step leaves the carry and the sums as they were
                    was = (m, l, acc) if name == "ring_fwd" else [
                        torch.zeros_like(t) for t in runs[0][name]]
                    ok &= all(torch.equal(a, b)
                              for a, b in zip(runs[0][name], was))
                if dt == torch.bfloat16:
                    errs[name] = max(errs[name], err)
                line.append(f"{name} err={err:.3e} repeat={same}")
                if not ok:
                    raise AssertionError(
                        f"[kernel3] {name} disagrees with its plain version "
                        f"or does not repeat: dtype={dt} S_l={s_l} "
                        f"layout={layout} member={my} resident={src} "
                        f"window={w} carry={carry} err={err} "
                        f"bit_identical={same}")
            log(f"[kernel3] {str(dt)[6:]:8s} S_l={s_l} {layout} member={my} "
                f"resident={src} window={w} carry={carry} "
                f"(atol=rtol={tol[dt]}): " + ", ".join(line)
                + f"; tensor-core launches {json.dumps(mma)}")
            if dt == torch.bfloat16 and not dead:
                # reported, not held: with the other steps' lse alone p
                # reaches e^7 and |dS| thousands, where a bf16 rounding of
                # dS that two summation orders of S or dP place on either
                # side of a tie moves dq or dk by ulp(dS) |k or q| scale
                odd = (q, k, v, do, lse_other, delta)
                dq = torch.zeros(q.shape, device="cuda")
                dk = torch.zeros(k.shape, device="cuda")
                dv = torch.zeros(k.shape, device="cuda")
                rf.ring_dq(*odd, dq, *offs)
                rf.ring_dkv(*odd, dk, dv, *offs)
                pairs = zip((dq, dk, dv), (rf.ring_dq_plain(*odd, *offs),
                                           *rf.ring_dkv_plain(*odd, *offs)))
                dev = [((got - ref).abs(), ref) for got, ref in pairs]
                log(f"[kernel3]   the same step at lse of the other steps "
                    f"only (p > 1): max |kernel - plain| dq/dk/dv "
                    + "/".join(f"{float(d.max()):.3e}" for d, _ in dev)
                    + ", elements past 2e-2 + 2e-2 |ref|: "
                    + "/".join(str(int((d > 2e-2 * (1 + r.abs())).sum()))
                               for d, r in dev))
            del runs, want, bwd

    # the last member's ring: q shard 3 against kv shards 3 (diagonal),
    # 2, 1 and 0 (past), as K3f meets them in the causal contiguous ring
    dt, my = torch.bfloat16, RING_N - 1
    (q, _, _, do), (m, l, acc, lse, delta) = ring_case(dt, RING_SL, SEED + 60,
                                                       "fresh")
    g = torch.Generator(device="cpu").manual_seed(SEED + 61)
    kv_all = torch.randn((TB, TS, 2, TKV, TD), generator=g).to("cuda", dt)
    shard = lambda i, j: kv_all[:, i * RING_SL:(i + 1) * RING_SL, j]
    q_off = rf.offsets(my, RING_N, RING_SL, "contiguous")
    steps = [(shard(src, 0), shard(src, 1),
              rf.offsets(src, RING_N, RING_SL, "contiguous"))
             for src in range(my, -1, -1)]
    lse = forward_lse(lse, q, [(k, k_off) for k, _, k_off in steps], q_off)
    dq = torch.zeros(q.shape, device="cuda")
    dk = torch.zeros(steps[0][0].shape, device="cuda")
    dv = torch.zeros_like(dk)

    def unit(which, plain: bool):
        def run():
            for k, v, k_off in steps:
                offs = (q_off, k_off, True, None)
                if which == "ring_fwd":
                    if plain:
                        rf.carry_fwd_plain(q, k, v, m, l, acc, *offs)
                    else:
                        rf.ring_fwd(q, k, v, m, l, acc, *offs)
                elif which == "ring_dq":
                    if plain:
                        rf.ring_dq_plain(q, k, v, do, lse, delta, *offs)
                    else:
                        rf.ring_dq(q, k, v, do, lse, delta, dq, *offs)
                elif plain:
                    rf.ring_dkv_plain(q, k, v, do, lse, delta, *offs)
                else:
                    rf.ring_dkv(q, k, v, do, lse, delta, dk, dv, *offs)
        return run

    # the yardstick: SDPA of q shard 3 over the whole sequence with the
    # global causal mask (forward, and backward through autograd yielding
    # dq, dk and dv together); the port never calls it
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2).detach()
    kt, vt = (kv_all[:, :, j].transpose(1, 2).detach() for j in (0, 1))
    q_ids = my * RING_SL + torch.arange(RING_SL, device="cuda")
    mask = torch.arange(TS, device="cuda")[None, :] <= q_ids[:, None]
    sdpa_fwd = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    with torch.no_grad():
        lib_fwd = time_ms(sdpa_fwd)
        lib_fwd_q = time_ms(sdpa_fwd, queued=True)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    o_s = sdpa(qg, kg, vg, attn_mask=mask, enable_gqa=True)
    dot = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(o_s, (qg, kg, vg), dot,
                                           retain_graph=True)
    lib_bwd = time_ms(sdpa_bwd)
    lib_bwd_q = time_ms(sdpa_bwd, queued=True)
    timings = {}
    for name in RING:
        p1 = time_ms(unit(name, True))
        k1 = time_ms(unit(name, False))
        k2 = time_ms(unit(name, False))
        p2 = time_ms(unit(name, True))
        # device time alone of the member's 4 launches, queued together
        kq = time_ms(unit(name, False), queued=True)
        bnd, by = bound_of([ring_launch_bound(
            name, dt, RING_SL, visible_pairs(q_off, k_off, RING_SL))
            for _, _, k_off in steps], dt)
        fwd = name == "ring_fwd"
        lib, lib_q = (lib_fwd, lib_fwd_q) if fwd else (lib_bwd, lib_bwd_q)
        timings[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                             library_ms=lib, bound_ms=bnd, bound_by=by,
                             device_ms=kq, library_device_ms=lib_q)
        log(f"[kernel3] timing {name} bf16, member {my} of {RING_N} over its "
            f"{len(steps)} live steps (B={TB} S_l={RING_SL} H={TH} KV={TKV} "
            f"D={TD}): kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} "
            f"ms, sdpa {'fwd' if fwd else 'bwd'} of the member's q over "
            f"S={TS} {lib:.4f} ms, bound {bnd:.4f} ms ({by}); device time "
            f"alone: kernel {kq:.4f} ms, sdpa {lib_q:.4f} ms")
    pair = timings["ring_dq"]["device_ms"] + timings["ring_dkv"]["device_ms"]
    log(f"[kernel3] K3q + K3kv, device time alone: {pair:.4f} ms against "
        f"sdpa bwd {lib_bwd_q:.4f} ms ({pair / lib_bwd_q:.2f}x)")
    # one launch each at a past (full) step and at the diagonal
    for label, (k, v, k_off) in (("past step", steps[1]),
                                 ("diagonal", steps[0])):
        offs = (q_off, k_off, True, None)
        one = {"ring_fwd": lambda: rf.ring_fwd(q, k, v, m, l, acc, *offs),
               "ring_dq": lambda: rf.ring_dq(q, k, v, do, lse, delta, dq,
                                             *offs),
               "ring_dkv": lambda: rf.ring_dkv(q, k, v, do, lse, delta, dk,
                                               dv, *offs)}
        for name, fn in one.items():
            t = time_ms(fn)
            bnd, by = bound_of([ring_launch_bound(
                name, dt, RING_SL, visible_pairs(q_off, k_off, RING_SL))], dt)
            log(f"[kernel3] one {name} launch, {label}: {t:.4f} ms, bound "
                f"{bnd:.4f} ms ({by})")
    return dict(errs=errs, timings=timings)


# --------------------------------------------------------- ring-train phase
def ring_live_pairs(n: int, s_l: int, layout: str, window=None) -> int:
    """(member, step) pairs of a causal ring with any visible pair: the
    launches of each K3 kernel per attention call."""
    from tf_operator_tpu_torch.ops import zigzag

    return sum(zigzag.pair_live(my, src, n, s_l, layout, window)
               for my in range(n) for src in range(n))


def ring_train_phase(first_loss: float) -> dict:
    """The train phase's run with attention through the ring: same seed
    weights, tokens and recipe."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.models.llama import params_flops_per_token
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import ring_flash as rf
    from tf_operator_tpu_torch.parallel.ring import LocalRing
    from tf_operator_tpu_torch.runtime.loop import run_training
    from tf_operator_tpu_torch.runtime.profiler import Profiler

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ring = LocalRing(RING_N)
    cfg = llama3_train_cfg(attention_fn=rf.make_ring_flash_attention_fn(ring))
    model, state, step = train_model(cfg)
    torch.cuda.synchronize()
    log(f"[ring-train] llama3_8b tied, remat, ring flash attention over "
        f"{ring} (contiguous, S_l={TS // RING_N}), {cfg.n_layers} layers; "
        f"batch {TB} x {TS}")
    losses, times = [], []

    def timed_step(state, tokens):
        t = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return state, metrics

    batches = train_llama.lm_batches(TB, TS, cfg.vocab_size, SEED + 4,
                                     device="cuda")
    fa.reset_launches()
    rf.reset_launches()
    res = run_training(state, timed_step, batches, num_steps=TRAIN_STEPS,
                       profiler=Profiler(batch_size=TB), log_interval_steps=1,
                       metrics_sink=lambda line: log(f"[ring-train] metrics "
                                                     f"{line}"))
    torch.cuda.synchronize()
    launches, k2 = dict(rf.launches), dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    del model, state, step, res
    torch.cuda.empty_cache()

    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[ring-train] losses {losses}")
    # bf16 compute: attention's rounding points differ (p and dS rounded
    # per ring step instead of per flash tile), nothing else does
    if abs(losses[0] - first_loss) > 2e-2:
        raise AssertionError(f"[ring-train] first loss {losses[0]} differs "
                             f"from the train phase's {first_loss} by more "
                             f"than 2e-2")
    live = ring_live_pairs(RING_N, TS // RING_N, "contiguous")
    bwd = live * cfg.n_layers * TRAIN_STEPS
    # every bf16 K3f, K3q and K3kv launch on the tensor cores
    want = {"ring_fwd": 2 * bwd, "ring_fwd_mma": 2 * bwd, "ring_dq": bwd,
            "ring_dq_mma": bwd, "ring_dkv": bwd, "ring_dkv_mma": bwd}
    if launches != want or any(k2.values()):
        raise AssertionError(f"[ring-train] K3 launches {launches}, expected "
                             f"{want} ({live} live pairs per layer); K2 "
                             f"launches {k2}, expected none")
    steady = sorted(times[1:])
    step_s = steady[len(steady) // 2]
    tokens_per_s = TB * TS / step_s
    mfu = tokens_per_s * params_flops_per_token(cfg) / PEAK_OPS_PER_S[
        torch.bfloat16]
    log(f"[ring-train] losses {[round(x, 4) for x in losses]} (train "
        f"phase's first {first_loss:.4f}); step_s "
        f"{[round(x, 4) for x in times]}; steady step_s (median of steps "
        f"2-{TRAIN_STEPS}) {step_s:.4f}, tokens_per_s {tokens_per_s:.2f}, "
        f"mfu {mfu:.4f}, max_memory_allocated_gib {peak / 2**30:.3f}, "
        f"kernel_launches {json.dumps(launches)} ({live} live pairs per "
        f"layer), k2_launches {json.dumps(k2)}")
    return dict(launches=launches)


def ring_parity_phase() -> None:
    """2 layers at full width, f32: one step's loss and gradient norms
    through the zigzag ring on the card, the same ring on the CPU, and
    the one-device flash attention on the card."""
    from tf_operator_tpu_torch.models import bridge, llama
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import ring_flash as rf
    from tf_operator_tpu_torch.ops import zigzag
    from tf_operator_tpu_torch.ops.blocked_ce import lm_blocked_loss
    from tf_operator_tpu_torch.parallel.ring import LocalRing

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seq = 256
    ring_fn = rf.make_ring_flash_attention_fn(LocalRing(RING_N),
                                              layout="zigzag")
    perm = torch.from_numpy(zigzag.storage_perm(RING_N, seq))
    params = bridge.init_params(llama3_train_cfg(n_layers=2,
                                                 dtype=torch.float32),
                                SEED + 8, device="cuda", train=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 9)
    runs = {}
    fa.reset_launches()
    rf.reset_launches()
    for label, dev, attn in (("ring cuda", "cuda", ring_fn),
                             ("ring cpu", "cpu", ring_fn),
                             ("flash cuda", "cuda", fa.flash_attention)):
        cfg = llama3_train_cfg(n_layers=2, dtype=torch.float32,
                               attention_fn=attn)
        model = llama.Llama.from_params(
            cfg, {k: v.to(dev) for k, v in params.items()}, device=dev,
            train=True)
        if not runs:
            tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=g)
        loss = lm_blocked_loss(model, tokens.to(dev),
                               perm=perm if attn is ring_fn else None)
        loss.backward()
        runs[label] = (loss.item(), {
            k: torch.linalg.vector_norm(p.grad, dtype=torch.float64).item()
            for k, p in model.named_parameters()})
        del model
    k3, k2 = dict(rf.launches), dict(fa.launches)
    del params
    torch.cuda.empty_cache()
    l_ref, n_ref = runs["ring cuda"]
    worst_all = 0.0
    for label in ("ring cpu", "flash cuda"):
        l_o, n_o = runs[label]
        loss_rel = abs(l_ref - l_o) / abs(l_o)
        norm_rel = {k: abs(n_ref[k] - n_o[k]) / max(n_o[k], 1e-30)
                    for k in n_o}
        worst = max(norm_rel, key=norm_rel.get)
        worst_all = max(worst_all, norm_rel[worst])
        log(f"[ring-parity] 2 layers f32, batch 1 x {seq}, zigzag ring of "
            f"{RING_N}: loss ring cuda {l_ref:.7f} vs {label} {l_o:.7f} (rel "
            f"{loss_rel:.2e}, limit 1e-5); {len(norm_rel)} gradient norms, "
            f"worst rel {norm_rel[worst]:.2e} ({worst}, limit 1e-4)")
        if not (math.isfinite(l_ref) and loss_rel <= 1e-5
                and norm_rel[worst] <= 1e-4):
            raise AssertionError(f"[ring-parity] the ring on the card and "
                                 f"{label} disagree")
    live = ring_live_pairs(RING_N, seq // RING_N, "zigzag")
    # remat: the forward runs again in the backward pass
    want_k3 = {"ring_fwd": 2 * 2 * live, "ring_fwd_mma": 0,
               "ring_dq": 2 * live, "ring_dq_mma": 0, "ring_dkv": 2 * live,
               "ring_dkv_mma": 0}
    if k3 != want_k3 or k2 != F32_K2_LAUNCHES:
        raise AssertionError(f"[ring-parity] launches K3 {k3} (expected "
                             f"{want_k3}), K2 {k2}")
    log(f"[ring-parity] launches K3 {json.dumps(k3)}, K2 {json.dumps(k2)}")


def ring_entry_phase() -> None:
    """train_llama's --ring entry point on the card: a ring of one member
    (one process, --tp 1), every attention through K3."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import ring_flash as rf

    fa.reset_launches()
    rf.reset_launches()
    rc = train_llama.main(["--smoke", "--ring", "--steps", "2"])
    torch.cuda.synchronize()
    k3, k2 = dict(rf.launches), dict(fa.launches)
    # tiny: 2 layers, no remat, a ring of one member: one pair per layer;
    # bf16 compute (D = 16), so K3f, K3q and K3kv run on the tensor cores
    want = {"ring_fwd": 4, "ring_fwd_mma": 4, "ring_dq": 4, "ring_dq_mma": 4,
            "ring_dkv": 4, "ring_dkv_mma": 4}
    log(f"[entry] train_llama --smoke --ring --steps 2: exit {rc}, K3 "
        f"launches {json.dumps(k3)}, K2 {json.dumps(k2)}")
    if rc != 0 or k3 != want or any(k2.values()):
        raise AssertionError(f"[entry] exit {rc}, K3 {k3} (expected {want}), "
                             f"K2 {k2}")


# ----------------------------------------------------------- profile phase
def _kernel_class(name: str) -> str:
    if any(k in name for k in ("paged_attention", "paged_mma", "paged_merge")):
        # the merge of the decode split is K1's or K1q's second pass
        return ("paged_attention int8 (K1q)" if "signed char" in name
                else "paged_attention (K1)")
    for kernel, label in (("flash_fwd", "flash fwd (K2f)"),
                          ("flash_dq", "flash dq (K2q)"),
                          ("flash_dkv", "flash dkv (K2kv)"),
                          ("ring_fwd", "ring fwd (K3f)"),
                          ("ring_dq", "ring dq (K3q)"),
                          ("ring_dkv", "ring dkv (K3kv)")):
        if kernel in name:
            return label
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


def profile_phase(int8: bool = False) -> None:
    """Where serving time goes at full width: one 8-step decode block of
    llama3_8b for 8 lanes at 512 positions each, and one 512-token
    prefill segment, each under torch.profiler; bf16 weights and KV, or
    (int8) int8 weights and KV."""
    from tf_operator_tpu_torch.models import bridge, llama, paging, serving

    cfg = llama.llama3_8b()
    params = (int8_params(cfg, SEED) if int8
              else bridge.init_params(cfg, SEED, device="cuda"))
    model = llama.Llama.from_params(cfg, params, device="cuda")
    del params
    tag = "int8 " if int8 else ""
    lanes, ctx, steps = 8, 512, 8
    per_lane = paging.blocks_for(ctx + steps, BS)
    cache = paging.init_block_pool(cfg, lanes * per_lane, BS, device="cuda",
                                   kv_quant=int8)
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
                 f"{tag}decode {lanes} lanes x ctx {ctx}", steps)
        _profile(lambda: serving.chunk_fill(model, cache, segment, 0,
                                            table[:1]),
                 f"{tag}prefill 1 lane x {ctx} tokens", 1)


def profile_train_phase(ring: bool = False) -> None:
    """Where a training step's time goes at full width: one llama3_8b
    step (batch 1 x 2048) under torch.profiler, with the one-device flash
    attention or (ring) ring flash attention over LocalRing(4)."""
    from tf_operator_tpu_torch import train_llama
    from tf_operator_tpu_torch.ops import ring_flash as rf
    from tf_operator_tpu_torch.parallel.ring import LocalRing

    kw = {}
    if ring:
        kw["attention_fn"] = rf.make_ring_flash_attention_fn(
            LocalRing(RING_N))
    cfg = llama3_train_cfg(**kw)
    model, state, step = train_model(cfg)
    tokens = next(train_llama.lm_batches(TB, TS, cfg.vocab_size, SEED + 4,
                                         device="cuda"))[0]
    label = f"ring train step (LocalRing({RING_N}))" if ring else "train step"
    _profile(lambda: step(state, tokens), f"{label} {TB} x {TS}", 1)
    del model, state, step
    torch.cuda.empty_cache()


# -------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import tf_operator_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    card = device_line()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    build()
    if sys.argv[1:] == ["--profile"]:
        profile_phase()
        torch.cuda.empty_cache()
        profile_phase(int8=True)
        torch.cuda.empty_cache()
        profile_train_phase()
        profile_train_phase(ring=True)
        return 0
    kern = kernel_phase()
    serve = serve_phase()
    spec = spec_phase(serve["model"], serve["prompts"], serve["tokens"])
    dense_phase(serve["model"], serve["prompts"], serve["tokens"])
    handoff_phase(serve.pop("model"))
    parity_phase()
    spec_parity = spec_parity_phase()
    dense_parity_phase()
    win = window_phase()
    win_parity = window_parity_phase()
    kern_win = window_kernel_phase()
    kern_win_q = window_kernel_phase(int8=True)
    kern2 = kernel2_phase()
    train = train_phase()
    train_parity_phase()
    kern1q = kernel_phase(int8=True)
    serve_int8 = serve_int8_phase()
    parity_int8_phase()
    kern3 = kernel3_phase()
    ring_train = ring_train_phase(train["losses"][0])
    ring_parity_phase()
    ring_entry_phase()

    def paged_row(name, line, kern, launches, verify=False):
        """K1's or K1q's row: decode times, prefill times beside them;
        verify=True: the spec phase's verify shape alone (L = 5)."""
        t = kern["timings"]["verify" if verify else "decode"]
        errs = kern["verify_errs" if verify else "errs"]
        row = {"name": name, "route": "cuda",
               "source": "tf_operator_tpu_torch/csrc/paged_attention.cu",
               "replaces": f"tf_operator_tpu/models/paged_attention.py:{line}",
               "launches": launches,
               "max_abs_err": errs[torch.bfloat16],
               "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "library_ms": t["library_ms"], "device_ms": t["device_ms"],
               "library_device_ms": t["library_device_ms"]}
        if not verify:
            pre = kern["timings"]["prefill"]
            row.update({"prefill_ms": pre["ms"],
                        "prefill_plain_ms": pre["plain_ms"],
                        "prefill_bound_ms": pre["bound_ms"],
                        "prefill_library_ms": pre["library_ms"],
                        "prefill_device_ms": pre["device_ms"],
                        "prefill_library_device_ms": pre["library_device_ms"]})
        return row

    rows = [paged_row("paged_attention", 96, kern, serve["launches"]),
            paged_row("paged_attention_int8", 259, kern1q,
                      serve_int8["launches"]),
            # the same kernels at the window phase's shapes: wrapped
            # 288-slot rings, window 4096
            paged_row("paged_attention_window", 96, kern_win,
                      win["launches"]),
            paged_row("paged_attention_int8_window", 259, kern_win_q,
                      win_parity["launches_int8"]),
            # the same kernels at the spec phase's verify shape (8 lanes
            # at L = 5); launches: every K1 call of the spec phase's
            # runs, and the spec-parity phase's int8 run for K1q
            paged_row("paged_attention_verify", 96, kern, spec["launches"],
                      verify=True),
            paged_row("paged_attention_int8_verify", 259, kern1q,
                      spec_parity["launches_int8"], verify=True)]
    # each row replaces the Pallas kernel body (_fwd_kernel, _dq_kernel,
    # _dkv_kernel)
    for name, line in (("flash_fwd", 112), ("flash_dq", 217),
                       ("flash_dkv", 256)):
        t = kern2["timings"][name]
        rows.append({"name": name, "route": "cuda",
                     "source": "tf_operator_tpu_torch/csrc/flash_attention.cu",
                     "replaces": f"tf_operator_tpu/ops/flash_attention.py:{line}",
                     "launches": train["launches"][name],
                     "max_abs_err": kern2["errs"][name],
                     "ms": t["ms"], "kernel_ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"],
                     "device_ms": t["device_ms"],
                     "library_device_ms": t["library_device_ms"]})
    # each row replaces the Pallas kernel body (_carry_fwd_kernel,
    # _dq_ring_kernel, _dkv_ring_kernel)
    for name, line in (("ring_fwd", 71), ("ring_dq", 156), ("ring_dkv", 191)):
        t = kern3["timings"][name]
        rows.append({"name": name, "route": "cuda",
                     "source": "tf_operator_tpu_torch/csrc/ring_flash.cu",
                     "replaces": f"tf_operator_tpu/ops/ring_flash.py:{line}",
                     "launches": ring_train["launches"][name],
                     "max_abs_err": kern3["errs"][name],
                     "ms": t["ms"], "kernel_ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"],
                     "device_ms": t["device_ms"],
                     "library_device_ms": t["library_device_ms"]})
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
