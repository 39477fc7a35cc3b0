"""Ring flash attention: the ring of ops/ring_attention.py with each step
run by a hand-written CUDA kernel that carries the online softmax.

The port of tf_operator_tpu/ops/ring_flash.py (`ring_flash_attention`,
Pallas TPU kernels behind a custom VJP inside shard_map).  The sequence
is split over a ring's members (parallel/ring.py); compact GQA kv shards
rotate around the ring, and each (member, live step) pair runs one
kernel launch:

  - K3f (`ring_fwd`): one step of the online-softmax forward of the
    member's q shard against the resident kv shard.  The running state
    (m, l [B, H, S_l] and the unnormalized acc [B, S_l, H, D], all f32)
    lives in device memory between steps and is updated in place.
  - K3q (`ring_dq`): one step's dQ contribution, added in place to the
    member's f32 dq.
  - K3kv (`ring_dkv`): one step's dK/dV contribution to the resident
    shard, summed over each kv head's query heads in the kernel and added
    in place to the f32 dk/dv that rotate with the shard.

CUDA tensors launch csrc/ring_flash.cu (built by kernels.py at first use)
or raise; each wrapper adds one to its count in `launches` per launch.
bf16 inputs take the tensor-core designs (`wgmma`, cp.async rings; K3f
and K3q blocks of 2 warpgroups of one GQA group, K3kv a cluster of 2
blocks per kv tile whose partials meet in distributed shared memory) and
also count in `launches["ring_fwd_mma"]`, `["ring_dq_mma"]` and
`["ring_dkv_mma"]`; f32 inputs run the scalar f32 designs.  CPU tensors
run the plain versions `carry_fwd_plain`, `ring_dq_plain` and
`ring_dkv_plain`: the kernels' arithmetic on one (member, step) in
whole-shard tensor ops.  `span_live` and `span_full` are the rule by which
the kernels skip tiles and drop the per-element mask, and `fwd_units` the
map by which K3f and K3q deal (q tile, query head) units to blocks.

Masks use global ids: a member's shard is two half-chunks whose global
starts are `offsets(idx, n, S_l, layout)` (contiguous: adjacent halves;
zigzag: chunks idx and 2n-1-idx), and row r has id off0 + r below the
half and off1 + r - half above it.  The kernels compute that id per row
and per key, so any S_local works (the TPU wrapper needs tiles that
divide the half and falls back to the einsum ring otherwise).  Pairs
(member, step) with no visible (query, key) pair launch nothing: the
causal contiguous ring's future shards, and with a window the steps
outside every band, which the rotation jumps over (ring_schedule).
Rows that see no key at all keep l == 0 and finish with output 0 and
lse = POS_INF, so the backward's exp(s - lse) is 0 for them.

Unlike the TPU, where the kv shard is repeated to H heads before each
step and dk/dv are folded back after it, the kernels read kv head h / G
directly and K3kv sums the group's query heads itself: no expand copy
and no fold pass.  Its f32 sums run in another order than JAX's.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Tuple

import torch

from tf_operator_tpu_torch import kernels
from tf_operator_tpu_torch.ops import zigzag
from tf_operator_tpu_torch.ops.ring_attention import (
    check_ring_args, ring_schedule, split_members)

NEG_INF = -1e30
POS_INF = 1e30

# kernel launches since the last reset, per kernel (plain-version calls
# are not counted); the *_mma counts: the bf16 launches among them, which
# ran on the tensor cores
launches: Dict[str, int] = {"ring_fwd": 0, "ring_fwd_mma": 0,
                            "ring_dq": 0, "ring_dq_mma": 0,
                            "ring_dkv": 0, "ring_dkv_mma": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FWD_GROUPS = 2  # warpgroups a tensor-core K3f block (kRfGroups)
_MAX_SMEM = 232448  # shared memory one H100 block may opt into
_lib: Optional[ctypes.CDLL] = None

Offsets = Tuple[int, int]


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def offsets(idx: int, n: int, s_local: int, layout: str) -> Offsets:
    """Global start ids of ring member `idx`'s two half-chunks.
    Contiguous shards are two adjacent halves (off1 = off0 + half), so
    the two-half id formula is plain `offset + row`; zigzag gives the
    member chunks (idx, 2n-1-idx) of the 2n global chunks."""
    half = s_local // 2
    if layout == "zigzag":
        return idx * half, (2 * n - 1 - idx) * half
    return idx * s_local, idx * s_local + half


# ------------------------------------------------------ which tiles run
def _id_hull(r_lo: int, r_hi: int, off: Offsets, s: int) -> Tuple[int, int]:
    """(lo, hi): the hull of the global ids of local rows r_lo ..
    min(r_hi, s - 1) of a shard with half-chunk starts off."""
    half, r_hi = s // 2, min(r_hi, s - 1)
    ids = []
    if r_lo < half:
        ids += [off[0] + r_lo, off[0] + min(r_hi, half - 1)]
    if r_hi >= half:
        ids += [off[1] + max(r_lo, half) - half, off[1] + r_hi - half]
    return min(ids), max(ids)


def span_live(q_lo: int, q_hi: int, k_lo: int, k_hi: int, q_off: Offsets,
              k_off: Offsets, s: int, causal: bool,
              window: Optional[int] = None) -> bool:
    """The kernels' `span_live` (csrc/ring_flash.cu): whether local q
    rows q_lo .. q_hi and keys k_lo .. k_hi may hold a visible pair.  A
    span that the kernels skip is one this returns False for: judged on
    the hulls of the spans' global ids, so it never drops a visible
    pair, and errs towards True only for spans straddling the halves."""
    if q_lo >= s or k_lo >= s:
        return False
    if not causal:
        return True
    qa, qb = _id_hull(q_lo, q_hi, q_off, s)
    ka, kb = _id_hull(k_lo, k_hi, k_off, s)
    return ka <= qb and (window is None or kb > qa - window)


def span_full(q_lo: int, q_hi: int, k_lo: int, k_hi: int, q_off: Offsets,
              k_off: Offsets, s: int, causal: bool,
              window: Optional[int] = None) -> bool:
    """The kernels' `span_full`: whether every pair of the spans is
    visible, so the per-element test is skipped.  Both spans must lie
    inside S and inside one half-chunk."""
    if q_hi >= s or k_hi >= s:
        return False
    if not causal:
        return True
    half = s // 2
    if q_lo < half <= q_hi or k_lo < half <= k_hi:
        return False
    qa, qb = _id_hull(q_lo, q_hi, q_off, s)
    ka, kb = _id_hull(k_lo, k_hi, k_off, s)
    return kb <= qa and (window is None or ka > qb - window)


def fwd_units(s: int, h: int, kv: int,
              groups: int = FWD_GROUPS) -> List[Tuple[int, int, int, int]]:
    """The tensor-core K3f's (and K3q's) map from (block, warpgroup) to
    the 64-row q tile and query head it computes (`first_unit` in
    csrc/ring_flash.cu), in launch order: (block, warpgroup, q tile,
    head) for each warpgroup that holds a unit.  The units of kv head j
    are u = (q tile) G + (head in group), head j G + u % G; a block of
    `groups` warpgroups takes `groups` consecutive units, blocks run
    over (unit block, kv head) with the kv head fastest and the unit
    blocks from the last, so under a causal mask the heaviest start
    first.  A unit no warpgroup takes would keep its carry unchanged."""
    g = h // kv
    n_units = -(-s // 64) * g
    per_head = -(-n_units // groups)
    out = []
    for x in range(per_head * kv):
        u0 = (per_head - 1 - x // kv) * groups
        for wg in range(groups):
            u = u0 + wg
            if u < n_units:
                out.append((x, wg, u // g, (x % kv) * g + u % g))
    return out


# ---------------------------------------------------------- plain versions
def _ids(off: Offsets, s: int, device) -> torch.Tensor:
    """[S] global id of each row of a shard with half-chunk starts off."""
    r = torch.arange(s, device=device)
    half = s // 2
    return torch.where(r < half, off[0] + r, off[1] + r - half)


def _mask(q_off: Offsets, k_off: Offsets, s: int, causal: bool,
          window: Optional[int], device) -> Optional[torch.Tensor]:
    """[S, S] bool: query row i may attend key row j (None: all)."""
    if not causal:
        return None
    qi = _ids(q_off, s, device)[:, None]
    ki = _ids(k_off, s, device)[None, :]
    mask = qi >= ki
    if window is not None:
        mask &= ki > qi - window
    return mask


def _scores(q, k, mask):
    """f32 scores [B, KV, G, S, S] (q.kᵀ then * scale, masked to
    NEG_INF); query head j*G + g reads kv head j."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d).float()
    sc = torch.einsum("bqjgd,bkjd->bjgqk", qg, k.float()) * (1.0 / math.sqrt(d))
    if mask is not None:
        sc = torch.where(mask, sc, NEG_INF)
    return sc


def _grouped(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """[B, H, S] statistics as [B, KV, G, S]."""
    b, h, s = x.shape
    return x.reshape(b, kvh, h // kvh, s)


def carry_fwd_plain(q, k, v, m, l, acc, q_off: Offsets, k_off: Offsets,
                    causal: bool, window: Optional[int] = None):
    """K3f's arithmetic on one (member, step): q [B,S,H,D] against the
    resident compact k/v [B,S,KV,D], carrying m, l [B,H,S] and acc
    [B,S,H,D] (f32).  Returns the new (m, l, acc).  Masked scores are
    NEG_INF and their p is 0 (also in a row with nothing visible yet,
    whose m stays NEG_INF); corr = exp(min(m_prev - m_new, 0)); p is
    rounded to v's dtype for the PV product."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    sc = _scores(q, k, _mask(q_off, k_off, s, causal, window, q.device))
    m_prev = _grouped(m, kvh)
    m_new = torch.maximum(m_prev, sc.amax(dim=-1))
    p = torch.where(sc <= NEG_INF / 2, 0.0, torch.exp(sc - m_new[..., None]))
    corr = torch.exp(torch.clamp(m_prev - m_new, max=0.0))
    l_new = _grouped(l, kvh) * corr + p.sum(dim=-1)
    pv = torch.einsum("bjgqk,bkjd->bqjgd", p.to(v.dtype).float(), v.float())
    acc_new = acc.reshape(b, s, kvh, g, d) * corr.permute(0, 3, 1, 2)[
        ..., None] + pv
    return (m_new.reshape(b, h, s), l_new.reshape(b, h, s),
            acc_new.reshape(b, s, h, d))


def _bwd_terms(q, k, v, do, lse, delta, q_off, k_off, causal, window):
    """p (f32) and dS = p (dP - delta) in f32, both [B, KV, G, S, S]."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    mask = _mask(q_off, k_off, s, causal, window, q.device)
    p = torch.exp(_scores(q, k, mask) - _grouped(lse, kvh)[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dog = do.reshape(b, s, kvh, h // kvh, d).float()
    dp = torch.einsum("bqjgd,bkjd->bjgqk", dog, v.float())
    return p, p * (dp - _grouped(delta, kvh)[..., None]), dog


def ring_dq_plain(q, k, v, do, lse, delta, q_off: Offsets, k_off: Offsets,
                  causal: bool, window: Optional[int] = None) -> torch.Tensor:
    """K3q's arithmetic: one step's f32 dq contribution [B,S,H,D],
    scale * (dS K) with dS rounded to k's dtype.  lse and delta are
    [B,H,S] f32."""
    b, s, h, d = q.shape
    _, ds, _ = _bwd_terms(q, k, v, do, lse, delta, q_off, k_off, causal,
                          window)
    dq = (1.0 / math.sqrt(d)) * torch.einsum(
        "bjgqk,bkjd->bqjgd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(b, s, h, d)


def ring_dkv_plain(q, k, v, do, lse, delta, q_off: Offsets, k_off: Offsets,
                   causal: bool, window: Optional[int] = None):
    """K3kv's arithmetic: one step's f32 (dk, dv) contributions
    [B,S,KV,D] to the resident shard, dk = scale * (dSᵀ Q) with dS
    rounded to q's dtype and dv = round(p)ᵀ dO with p rounded to dO's,
    each summed over the kv head's query heads."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    p, ds, dog = _bwd_terms(q, k, v, do, lse, delta, q_off, k_off, causal,
                            window)
    qg = q.reshape(b, s, kvh, h // kvh, d).float()
    dk = (1.0 / math.sqrt(d)) * torch.einsum(
        "bjgqk,bqjgd->bkjd", ds.to(q.dtype).float(), qg)
    dv = torch.einsum("bjgqk,bqjgd->bkjd", p.to(do.dtype).float(), dog)
    return dk, dv


# ------------------------------------------------------------------ kernels
def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = kernels.load("ring_flash")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        shape = [i32] * 5 + [i32] * 4 + [i32, i32, f32, i32, ptr]
        lib.ring_fwd_launch.argtypes = [ptr] * 7 + shape
        lib.ring_dq_launch.argtypes = [ptr] * 8 + shape
        lib.ring_dkv_launch.argtypes = [ptr] * 9 + shape
        for fn in (lib.ring_fwd_launch, lib.ring_dq_launch,
                   lib.ring_dkv_launch):
            fn.restype = i32
        lib.ring_max_head_dim.argtypes = []
        lib.ring_max_head_dim.restype = i32
        lib.ring_smem_bytes.argtypes = [i32, i32, i32]
        lib.ring_smem_bytes.restype = ctypes.c_longlong
        lib.ring_error_string.argtypes = [i32]
        lib.ring_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(which: int, inputs: Dict[str, torch.Tensor],
           state: Dict[str, torch.Tensor], causal: bool,
           window: Optional[int]) -> ctypes.CDLL:
    """Raise on what the kernels do not take; returns the library.
    `inputs` are q, k, v (and do) in one dtype, [B, S, heads, D] with
    unit stride on D; `state` are contiguous f32 tensors of the shapes
    the kernel reads and writes."""
    q, k, v = inputs["q"], inputs["k"], inputs["v"]
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype}: the kernels take float32 or "
                        f"bfloat16")
    for name, t in inputs.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} must match q "
                            f"({q.dtype})")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be [B, S, heads, D] with unit "
                             f"stride on D, got {tuple(t.shape)} strides "
                             f"{t.stride()}")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh or k.shape != (b, s, kvh, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} are not one shard's GQA shapes")
    if "do" in inputs and inputs["do"].shape != q.shape:
        raise ValueError(f"do {tuple(inputs['do'].shape)} must match q")
    want = {"m": (b, h, s), "l": (b, h, s), "lse": (b, h, s),
            "delta": (b, h, s), "acc": (b, s, h, d), "dq": (b, s, h, d),
            "dk": (b, s, kvh, d), "dv": (b, s, kvh, d)}
    for name, t in state.items():
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != want[name]):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{list(want[name])} tensor on {dev}")
    if window is not None and (not causal or window < 1):
        raise ValueError(f"window {window} needs causal=True and >= 1")
    lib = _load()
    if d > lib.ring_max_head_dim():
        raise ValueError(f"head_dim {d} > the kernels' "
                         f"{lib.ring_max_head_dim()}")
    if lib.ring_smem_bytes(which, d, _DTYPES[q.dtype]) > _MAX_SMEM:
        raise ValueError(f"head_dim {d} needs more shared memory than one "
                         f"block can have")
    if b > 65535 or h > 65535:
        raise ValueError(f"B={b} and H={h} must be <= 65535 (grid dims)")
    return lib


def _strides(*ts: torch.Tensor):
    vals = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _shape_args(q, k, q_off, k_off, causal, window):
    b, s, h, d = q.shape
    return (b, s, h, k.shape[2], d, int(q_off[0]), int(q_off[1]),
            int(k_off[0]), int(k_off[1]), int(causal),
            -1 if window is None else int(window), 1.0 / math.sqrt(d),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)


def _raise_on(err: int, lib: ctypes.CDLL, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.ring_error_string(err).decode()} ({err})")


def _on(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ring flash attention runs on cuda or cpu, got "
                         f"{x.device}")
    return x.device.type


def ring_fwd(q, k, v, m, l, acc, q_off: Offsets, k_off: Offsets,
             causal: bool, window: Optional[int] = None) -> None:
    """K3f: one forward ring step, updating (m, l, acc) in place.  CUDA
    tensors launch the kernel (or raise; bf16 on the tensor cores); CPU
    tensors run carry_fwd_plain."""
    if _on(q) == "cpu":
        for dst, src in zip((m, l, acc), carry_fwd_plain(
                q, k, v, m, l, acc, q_off, k_off, causal, window)):
            dst.copy_(src)
        return
    lib = _check(0, dict(q=q, k=k, v=v), dict(m=m, l=l, acc=acc), causal,
                 window)
    err = lib.ring_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(), _strides(q, k, v),
        *_shape_args(q, k, q_off, k_off, causal, window))
    _raise_on(err, lib, "ring_fwd")
    launches["ring_fwd"] += 1
    if q.dtype == torch.bfloat16:
        launches["ring_fwd_mma"] += 1


def ring_dq(q, k, v, do, lse, delta, dq, q_off: Offsets, k_off: Offsets,
            causal: bool, window: Optional[int] = None) -> None:
    """K3q: adds one step's dq contribution to the f32 dq in place."""
    if _on(q) == "cpu":
        dq.add_(ring_dq_plain(q, k, v, do, lse, delta, q_off, k_off, causal,
                              window))
        return
    lib = _check(1, dict(q=q, k=k, v=v, do=do),
                 dict(lse=lse, delta=delta, dq=dq), causal, window)
    err = lib.ring_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, do),
        *_shape_args(q, k, q_off, k_off, causal, window))
    _raise_on(err, lib, "ring_dq")
    launches["ring_dq"] += 1
    if q.dtype == torch.bfloat16:
        launches["ring_dq_mma"] += 1


def ring_dkv(q, k, v, do, lse, delta, dk, dv, q_off: Offsets,
             k_off: Offsets, causal: bool,
             window: Optional[int] = None) -> None:
    """K3kv: adds one step's dk/dv contributions to the resident shard's
    f32 dk and dv in place."""
    if _on(q) == "cpu":
        dk_c, dv_c = ring_dkv_plain(q, k, v, do, lse, delta, q_off, k_off,
                                    causal, window)
        dk.add_(dk_c)
        dv.add_(dv_c)
        return
    lib = _check(2, dict(q=q, k=k, v=v, do=do),
                 dict(lse=lse, delta=delta, dk=dk, dv=dv), causal, window)
    err = lib.ring_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, do),
        *_shape_args(q, k, q_off, k_off, causal, window))
    _raise_on(err, lib, "ring_dkv")
    launches["ring_dkv"] += 1
    if q.dtype == torch.bfloat16:
        launches["ring_dkv_mma"] += 1


# ------------------------------------------------------------------- ring
def _live(ring, my: int, step: int, s_l: int, causal, layout, window):
    """(src, live) of member `my` at ring step `step`."""
    n = ring.size
    src = (my - step) % n
    return src, zigzag.pair_live(my, src, n, s_l, layout, window, causal)


def _ring_fwd_pass(ring, qs, ks, vs, causal, layout, window):
    """Each held member's (out [B,S_l,H,D] in q's dtype, lse [B,H,S_l])."""
    n = ring.size
    b, s_l, h, d = qs[0].shape
    dev = qs[0].device
    ms = [torch.full((b, h, s_l), NEG_INF, dtype=torch.float32, device=dev)
          for _ in qs]
    ls = [torch.zeros((b, h, s_l), dtype=torch.float32, device=dev)
          for _ in qs]
    accs = [torch.zeros((b, s_l, h, d), dtype=torch.float32, device=dev)
            for _ in qs]
    kv = list(zip(ks, vs))
    for step, hop in ring_schedule(n, s_l, layout, window, causal):
        if hop:
            kv = ring.rotate(kv, hop)
        for i, my in enumerate(ring.members):
            src, live = _live(ring, my, step, s_l, causal, layout, window)
            if live:
                ring_fwd(qs[i], kv[i][0], kv[i][1], ms[i], ls[i], accs[i],
                         offsets(my, n, s_l, layout),
                         offsets(src, n, s_l, layout), causal, window)
    outs, lses = [], []
    for q, m, l, acc in zip(qs, ms, ls, accs):
        l_safe = torch.where(l == 0.0, 1.0, l)
        outs.append((acc / l_safe.transpose(1, 2)[..., None]).to(q.dtype))
        # rows that saw no key: zero output, +inf lse so exp(s - lse) = 0
        lses.append(torch.where(l == 0.0, POS_INF, m + torch.log(l_safe)))
    return outs, lses


def _ring_bwd_pass(ring, qs, ks, vs, outs, lses, dos, causal, layout,
                   window):
    """Each held member's (dq, dk, dv) in the inputs' dtypes.  dq
    accumulates in place; (k, v, dk, dv) rotate together between live
    steps and then close the loop, so every shard has collected each
    live member's contribution and is home again."""
    n = ring.size
    b, s_l, h, d = qs[0].shape
    dev = qs[0].device
    dos = [do if do.stride(-1) == 1 else do.contiguous() for do in dos]
    # delta from the rounded output, in f32, as [B, H, S_l]
    deltas = [(o.float() * do.float()).sum(dim=-1).transpose(1, 2)
              .contiguous() for o, do in zip(outs, dos)]
    dqs = [torch.zeros((b, s_l, h, d), dtype=torch.float32, device=dev)
           for _ in qs]
    kvg = [(k, v, torch.zeros(k.shape, dtype=torch.float32, device=dev),
            torch.zeros(v.shape, dtype=torch.float32, device=dev))
           for k, v in zip(ks, vs)]
    rotated = 0
    for step, hop in ring_schedule(n, s_l, layout, window, causal):
        if hop:
            kvg = ring.rotate(kvg, hop)
            rotated = step
        for i, my in enumerate(ring.members):
            src, live = _live(ring, my, step, s_l, causal, layout, window)
            if not live:
                continue
            k_res, v_res, dk_res, dv_res = kvg[i]
            args = (qs[i], k_res, v_res, dos[i], lses[i], deltas[i])
            offs = (offsets(my, n, s_l, layout), offsets(src, n, s_l, layout),
                    causal, window)
            ring_dq(*args, dqs[i], *offs)
            ring_dkv(*args, dk_res, dv_res, *offs)
    if rotated % n:
        # close the loop: the dk/dv a member holds travel the remaining
        # hops back to the shard's home
        kvg = ring.rotate(kvg, n - rotated)
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [g[2].to(k.dtype) for g, k in zip(kvg, ks)],
            [g[3].to(v.dtype) for g, v in zip(kvg, vs)])


class _RingFlash(torch.autograd.Function):
    """Inputs: the held members' q shards, then k, then v; outputs: their
    output shards."""

    @staticmethod
    def forward(ctx, ring, causal, layout, window, *tensors):
        c = len(tensors) // 3
        qs, ks, vs = tensors[:c], tensors[c:2 * c], tensors[2 * c:]
        outs, lses = _ring_fwd_pass(ring, qs, ks, vs, causal, layout,
                                    window)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.ring, ctx.causal, ctx.layout, ctx.window = (ring, causal, layout,
                                                        window)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dos):
        saved = ctx.saved_tensors
        c = len(dos)
        qs, ks, vs, outs, lses = (saved[i * c:(i + 1) * c] for i in range(5))
        dqs, dks, dvs = _ring_bwd_pass(ctx.ring, qs, ks, vs, outs, lses,
                                       dos, ctx.causal, ctx.layout,
                                       ctx.window)
        return (None,) * 4 + tuple(dqs) + tuple(dks) + tuple(dvs)


def ring_flash_attention(qs: List[torch.Tensor], ks: List[torch.Tensor],
                         vs: List[torch.Tensor], causal: bool = False, *,
                         ring, layout: str = "contiguous",
                         window: Optional[int] = None) -> List[torch.Tensor]:
    """Sequence-parallel flash attention, differentiable: qs[i]
    [B, S_local, H, D] and compact ks[i], vs[i] [B, S_local, KV, D] are
    the shards of ring member ring.members[i].  Returns each held
    member's output shard.  layout="zigzag" expects shards in zigzag
    storage order (ops/zigzag.py).  window (causal only): each query sees
    itself and the window-1 previous positions; steps outside every band
    are skipped with multi-hop rotations."""
    check_ring_args(qs, ks, vs, ring, causal, layout, window)
    return list(_RingFlash.apply(ring, causal, layout, window,
                                 *qs, *ks, *vs))


def make_ring_flash_attention_fn(ring_or_mesh, *args, **kwargs):
    """An attention_fn for models/llama (cfg.attention_fn), in either of
    two forms:

      - make_ring_flash_attention_fn(ring, layout="contiguous"): splits
        [B, S, H, D] q and [B, S, KV, D] k/v along S over the members
        this process holds (a LocalRing: every member; a ProcessRing: S
        is this rank's shard) and runs ring_flash_attention;
      - make_ring_flash_attention_fn(mesh, axis_name="tp",
        batch_axes=("dcn", "dp", "fsdp"), layout="contiguous"): JAX's
        form, the ring over the mesh axis (`_mesh_attention_fn`).

    With layout="zigzag" the token stream must be permuted into zigzag
    storage order once outside the step (ops/zigzag.to_storage, and
    positions=storage_perm for the model)."""
    from tf_operator_tpu_torch.parallel.mesh import Mesh

    if isinstance(ring_or_mesh, Mesh):
        return _mesh_attention_fn(ring_or_mesh, *args, **kwargs)
    return _ring_attention_fn(ring_or_mesh, *args, **kwargs)


def _ring_attention_fn(ring, layout: str = "contiguous"):
    def attention_fn(q, k, v, causal: bool, window=None) -> torch.Tensor:
        out = ring_flash_attention(
            split_members(q, ring), split_members(k, ring),
            split_members(v, ring), causal, ring=ring, layout=layout,
            window=window)
        return torch.cat(out, dim=1)

    # compact-kv (GQA) inputs rotate unexpanded around the ring
    attention_fn.supports_gqa = True
    attention_fn.ring = ring
    return attention_fn


def first_copies(ids: List[int]) -> List[int]:
    """The position of each distinct id's first copy in `ids`, by id
    (negative ids skipped)."""
    first: Dict[int, int] = {}
    for i, x in enumerate(ids):
        if x >= 0:
            first.setdefault(x, i)
    return [first[x] for x in sorted(first)]


def _mesh_attention_fn(mesh, axis_name: str = "tp",
                       batch_axes=("dcn", "dp", "fsdp"),
                       layout: str = "contiguous"):
    """JAX's make_ring_flash_attention_fn(mesh, axis_name): ring flash
    attention whose members are the ranks along `axis_name`, member i
    the rank at coordinate i (a ProcessRing over mesh.group(axis_name);
    a LocalRing(1) where the axis has size 1).

    JAX's shard_map takes [B, S, H, D] with S split over the axis and
    every head on each device, while its tp rules split the heads: GSPMD
    reshards at the boundary.  The port runs tp Megatron-style, so the
    model hands this function its own heads ([B, S, H/n, D] q, its kv
    heads) over the whole sequence, and the reshard is explicit: one
    all-to-all over the axis (parallel/comm.exchange) turns q, k and v
    into this rank's sequence block of every head, the ring runs on it,
    and a second turns the output back into this rank's heads.  The
    backward runs the two exchanges the other way.  Where the kv heads
    do not divide the axis, each rank holds the kv heads its query
    heads read (parallel/tp.kv_heads_of, given `n_kv_heads`, which the
    model passes; ranks may hold different numbers, padded to one width
    for the exchange); the exchange then brings copies of some kv heads,
    and the ring takes each kv head's first copy, in order, whose
    gradient alone is non-zero (the placement sums a replicated wkv's
    gradient over tp).  The batch needs nothing: each rank already holds
    its data member's rows, which is what `batch_axes` splits in JAX."""
    from tf_operator_tpu_torch.parallel import comm
    from tf_operator_tpu_torch.parallel.ring import LocalRing, ProcessRing
    from tf_operator_tpu_torch.parallel.tp import kv_heads_of

    n = mesh.shape[axis_name]
    if n == 1:
        return _ring_attention_fn(LocalRing(1), layout)
    group = mesh.group(axis_name)
    if group is None:
        raise ValueError(f"a ring over {axis_name} ({n}) needs the mesh of "
                         f"a job of processes (make_mesh inside the job)")
    ring = ProcessRing(group)
    if ring.rank != mesh.coords()[axis_name]:
        raise AssertionError(f"ring member {ring.rank} is not the rank's "
                             f"{axis_name} coordinate {mesh.coords()}")

    def attention_fn(q, k, v, causal: bool, window=None,
                     n_kv_heads: Optional[int] = None) -> torch.Tensor:
        b, s, h, d = q.shape
        heads = h * n
        n_kv = k.shape[2] * n if n_kv_heads is None else n_kv_heads
        held = [kv_heads_of(heads, n_kv, r, n) for r in range(n)]
        if len(held[ring.rank]) != k.shape[2]:
            raise ValueError(f"{k.shape[2]} kv heads on tp rank {ring.rank}"
                             f", where kv_heads_of gives {held[ring.rank]}")
        # every rank's kv heads padded to one width, so the exchange
        # moves equal chunks; -1 marks a padding head
        width = max(map(len, held))
        ids = [j for r in held for j in r + [-1] * (width - len(r))]
        pad = width - k.shape[2]
        if pad:
            k, v = (torch.cat([t, t.new_zeros((b, s, pad, d))], dim=2)
                    for t in (k, v))
        # this rank's sequence block of every member's heads:
        # [B, S/n, n * (h + 2 width), D], member i's q, k, v first-major
        x = comm.exchange(torch.cat([q, k, v], dim=2), group, 1, 2)
        x = x.unflatten(2, (n, h + 2 * width))
        qs = x[:, :, :, :h].flatten(2, 3)
        ks = x[:, :, :, h:h + width].flatten(2, 3)
        vs = x[:, :, :, h + width:].flatten(2, 3)
        pick = first_copies(ids)
        if pick != list(range(len(ids))):
            pick = torch.tensor(pick, device=q.device)
            ks, vs = ks.index_select(2, pick), vs.index_select(2, pick)
        out = ring_flash_attention(
            [qs.contiguous()], [ks.contiguous()], [vs.contiguous()], causal,
            ring=ring, layout=layout, window=window)[0]
        # back to this rank's heads over the whole sequence
        return comm.exchange(out, group, 2, 1)

    attention_fn.supports_gqa = True
    # models/llama passes its n_kv_heads to a tp-placed model's call
    attention_fn.tp_heads = True
    attention_fn.ring = ring
    return attention_fn
