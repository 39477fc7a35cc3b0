"""Ring attention: sequence parallelism over the members of a ring.

The port of tf_operator_tpu/ops/ring_attention.py, and the plain
reference of the whole ring algorithm (ops/ring_flash.py runs the same
ring through the CUDA kernels K3f/K3q/K3kv).  The sequence is split over
the ring's members (parallel/ring.py): each member holds S/n of q, k and
v and, over the ring's live steps, attends to the kv shard currently
resident, merging partial results with the running (m, l) softmax while
the kv shards rotate around the ring.  Causal masking uses each member's
global positions, so shards strictly in the future contribute exactly
zero.

Each step runs under torch.utils.checkpoint when gradients are taken, so
the backward recomputes the block scores instead of saving n of them.
Autograd differentiates through the ring: a LocalRing rotation is a
re-indexing, a ProcessRing rotation an exchange whose backward rotates
the other way.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.utils.checkpoint

from tf_operator_tpu_torch.ops import zigzag
from tf_operator_tpu_torch.ops.flash_attention import check_gqa_shapes

NEG_INF = -1e30


def _merge_block(o, m, l, q, k, v, q_pos, k_pos, causal: bool,
                 window: Optional[int]):
    """One ring step: blockwise attention of q [B,Sq,H,D] against the
    compact k/v [B,Sk,KV,D] (query head j*G + g reads kv head j) with the
    global-position causal (and sliding-window) mask, merged into the
    running o [B,Sq,H,D], m and l [B,H,Sq] (all f32)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d).float()
    s = torch.einsum("bqjgd,bkjd->bjgqk", qg, k.float()).reshape(
        b, h, sq, -1) * (1.0 / math.sqrt(d))
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]          # [Sq, Sk] global
        if window is not None:
            # each query sees itself + window-1 previous positions
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))              # [B,H,Sq]
    # exp(NEG_INF - m) underflows to 0 unless m is itself NEG_INF (a row
    # masked so far); guard so masked entries never contribute exp(0)=1
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - m_new[..., None]))
    corr = torch.exp(torch.clamp(m - m_new, max=0.0))
    l_new = l * corr + p.sum(dim=-1)
    pg = p.reshape(b, kvh, g, sq, -1).to(v.dtype).float()
    pv = torch.einsum("bjgqk,bkjd->bqjgd", pg, v.float()).reshape(b, sq, h, d)
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def ring_schedule(n: int, s_local: int, layout: str, window, causal):
    """[(step, hop)] over the live ring steps: `hop` is the rotation to
    apply before computing that step (0 for the first).  Shared by the
    einsum and the kernel rings."""
    out, prev = [], 0
    for t in zigzag.live_ring_steps(n, s_local, layout, window, causal):
        out.append((t, t - prev))
        prev = t
    return out


def _positions(idx: int, n: int, s_local: int, layout: str,
               device=None) -> torch.Tensor:
    """[s_local] global position ids ring member `idx` holds."""
    if layout == "zigzag":
        return zigzag.device_positions(idx, n, s_local, device=device)
    return idx * s_local + torch.arange(s_local, dtype=torch.int32,
                                        device=device)


def check_ring_args(qs, ks, vs, ring, causal: bool, layout: str,
                    window: Optional[int]) -> None:
    """What both rings refuse: a window without causal or below 1, a
    shard count that is not the held members', unequal shards, and an odd
    zigzag shard."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"layout {layout!r}: contiguous or zigzag")
    if not (len(qs) == len(ks) == len(vs) == len(ring.members)):
        raise ValueError(f"{len(qs)}/{len(ks)}/{len(vs)} q/k/v shards for "
                         f"{len(ring.members)} held ring members")
    for q, k, v in zip(qs, ks, vs):
        check_gqa_shapes(q, k, v)
        if q.shape != qs[0].shape or k.shape != ks[0].shape:
            raise ValueError("every member's shards must have one shape")
    s_local = qs[0].shape[1]
    if layout == "zigzag" and s_local % 2:
        raise ValueError(f"layout='zigzag' needs an even per-member "
                         f"sequence, got S_local={s_local}")


def ring_attention(qs: List[torch.Tensor], ks: List[torch.Tensor],
                   vs: List[torch.Tensor], causal: bool = False, *, ring,
                   layout: str = "contiguous",
                   window: Optional[int] = None) -> List[torch.Tensor]:
    """Attention over sequence shards: qs[i] [B, S_local, H, D] and
    ks[i], vs[i] [B, S_local, KV, D] are the shards of ring member
    ring.members[i] (KV == H, or fewer heads for GQA).  Returns each held
    member's output shard in q's dtype.  layout="zigzag" expects shards
    in zigzag storage order (ops/zigzag.py) and masks by the matching
    global positions.  window (causal only): ring steps whose resident kv
    lies wholly outside every band are skipped, with one multi-hop
    rotation between live steps."""
    check_ring_args(qs, ks, vs, ring, causal, layout, window)
    n = ring.size
    b, s_local, h, d = qs[0].shape
    dev = qs[0].device
    q_pos = [_positions(my, n, s_local, layout, dev) for my in ring.members]
    o = [torch.zeros((b, s_local, h, d), dtype=torch.float32, device=dev)
         for _ in qs]
    m = [torch.full((b, h, s_local), NEG_INF, dtype=torch.float32,
                    device=dev) for _ in qs]
    l = [torch.zeros((b, h, s_local), dtype=torch.float32, device=dev)
         for _ in qs]
    kv = [(k, v) for k, v in zip(ks, vs)]
    grad = torch.is_grad_enabled()
    for step, hop in ring_schedule(n, s_local, layout, window, causal):
        if hop:
            kv = ring.rotate(kv, hop)
        for i, my in enumerate(ring.members):
            src = (my - step) % n    # ring origin of the resident kv
            args = (o[i], m[i], l[i], qs[i], kv[i][0], kv[i][1], q_pos[i],
                    _positions(src, n, s_local, layout, dev), causal, window)
            if grad:
                o[i], m[i], l[i] = torch.utils.checkpoint.checkpoint(
                    _merge_block, *args, use_reentrant=False)
            else:
                o[i], m[i], l[i] = _merge_block(*args)
    out = []
    for oi, li, q in zip(o, l, qs):
        l_safe = torch.where(li == 0.0, 1.0, li)
        out.append((oi / l_safe.transpose(1, 2)[..., None]).to(q.dtype))
    return out


def split_members(x: torch.Tensor, ring) -> List[torch.Tensor]:
    """x [B, S, ...] as the shards of the members this process holds
    (views along S, no copy)."""
    n = len(ring.members)
    if x.shape[1] % n:
        raise ValueError(f"sequence {x.shape[1]} does not split over "
                         f"{n} ring members")
    return list(torch.chunk(x, n, dim=1))


def make_ring_attention_fn(ring, layout: str = "contiguous"):
    """An attention_fn for models/llama (cfg.attention_fn): splits
    [B, S, H, D] q and [B, S, KV, D] k/v along S over the members this
    process holds and runs ring_attention.  With a LocalRing that is the
    whole sequence over every member; with a ProcessRing, S is this
    rank's shard."""

    def attention_fn(q, k, v, causal: bool, window=None) -> torch.Tensor:
        out = ring_attention(split_members(q, ring), split_members(k, ring),
                             split_members(v, ring), causal, ring=ring,
                             layout=layout, window=window)
        return torch.cat(out, dim=1)

    # compact-kv (GQA) inputs rotate unexpanded around the ring
    attention_fn.supports_gqa = True
    return attention_fn
