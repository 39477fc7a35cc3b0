"""Zigzag (load-balanced) sequence layout for causal ring attention.

The port of tf_operator_tpu/ops/zigzag.py, on numpy and torch.  With
contiguous sequence shards, causal ring attention is imbalanced: at ring
step t only members `my >= t` hold unmasked work.  The zigzag layout
splits the sequence into 2n chunks and gives member i chunks
(i, 2n-1-i), one early chunk and one late chunk, so every (member, step)
pair carries about the same causal work.

Positions are then no longer `offset + iota` per shard: this module
holds the per-member global-position math for the rings
(ops/ring_attention.py, ops/ring_flash.py) and the host-side permutations
between logical token order and zigzag storage order.  The permutation is
applied once to the token stream outside the step; absolute position ids
(`positions=storage_perm(n, S)` to models/llama.Llama) and labels ride
with it, and a next-token shift is taken in logical order.
"""
from __future__ import annotations

import numpy as np
import torch


def chunk_ids(n: int):
    """Per-member (early, late) chunk ids: member i of n holds chunks
    (i, 2n-1-i) of the 2n equal chunks."""
    return [(i, 2 * n - 1 - i) for i in range(n)]


def device_positions(idx: int, n: int, s_local: int, device=None
                     ) -> torch.Tensor:
    """[s_local] int32 global (logical) position ids held by ring member
    `idx` under the zigzag layout."""
    c = s_local // 2
    i = torch.arange(c, dtype=torch.int32, device=device)
    return torch.cat([idx * c + i, (2 * n - 1 - idx) * c + i])


def storage_perm(n: int, s: int) -> np.ndarray:
    """perm such that `x[perm]` reorders a logical-order [S, ...] array
    into zigzag storage order: contiguous equal sharding of the result
    over n members gives member i chunks (i, 2n-1-i)."""
    if s % (2 * n):
        raise ValueError(f"sequence {s} not divisible by 2*n = {2 * n}")
    c = s // (2 * n)
    order = []
    for a, b in chunk_ids(n):
        order.extend(range(a * c, (a + 1) * c))
        order.extend(range(b * c, (b + 1) * c))
    return np.asarray(order, dtype=np.int32)


def inverse_perm(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return inv


def member_intervals(idx: int, n: int, s_local: int, layout: str):
    """Closed global-position intervals [(lo, hi), ...] ring member `idx`
    holds (host ints)."""
    if layout == "zigzag":
        c = s_local // 2
        return [(idx * c, (idx + 1) * c - 1),
                ((2 * n - 1 - idx) * c, (2 * n - idx) * c - 1)]
    return [(idx * s_local, (idx + 1) * s_local - 1)]


def pair_live(my: int, src: int, n: int, s_local: int, layout: str,
              window, causal: bool = True) -> bool:
    """Whether member `my`'s queries see any key of member `src`'s shard
    under the causal (and sliding-window) mask."""
    if not causal:
        return True
    w = float("inf") if window is None else window
    for qa, qb in member_intervals(my, n, s_local, layout):
        for ka, kb in member_intervals(src, n, s_local, layout):
            # band pairs: 0 <= q - k <= window-1 for some q, k
            if qb >= ka and qa - kb <= w - 1:
                return True
    return False


def live_ring_steps(n: int, s_local: int, layout: str, window,
                    causal: bool = True):
    """The ring steps with any live (query, key) pair on any member under
    a causal sliding-window band of `window` positions (None: every step;
    plain causal keeps all n steps live, since at step t member my >= t
    still attends src = my - t).  A resident shard wholly outside every
    band contributes zero, so the whole step and its rotation are
    skipped; callers jump the ring by multi-hop rotations."""
    if not causal or window is None:
        return list(range(n))
    return [t for t in range(n)
            if any(pair_live(my, (my - t) % n, n, s_local, layout, window)
                   for my in range(n))]


def to_storage(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Gather a logical-order tensor into zigzag storage order along
    `axis` (once per batch, not per layer)."""
    idx = torch.from_numpy(storage_perm(n, x.shape[axis])).to(x.device)
    return torch.index_select(x, axis, idx.long())


def from_storage(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Inverse of `to_storage`."""
    perm = storage_perm(n, x.shape[axis])
    idx = torch.from_numpy(inverse_perm(perm)).to(x.device)
    return torch.index_select(x, axis, idx.long())
