"""Ulysses-style sequence parallelism: all-to-all head/sequence exchange.

The port of tf_operator_tpu/ops/ulysses.py (DeepSpeed-Ulysses).  With
the sequence split over a group, one all-to-all turns [B, S/n, H, D]
into [B, S, H/n, D], so each member computes *exact* attention over the
whole sequence for its heads (no blockwise softmax merging, O(S²/n)
score memory), and a second all-to-all returns the sequence block; the
collective volume is 2 x the activation, where the ring moves kv n
times.  Ulysses needs H % n == 0 and holds full-length scores per local
head; the ring (ops/ring_flash) keeps O((S/n)²) and wins at extreme
lengths.  Both are attention functions of one interface, so models
switch by config.

`ulysses_attention` is the exchange itself over a process group
(parallel/comm.exchange, whose backward is the all-to-all the other
way).  `make_ulysses_attention_fn(mesh, axis_name)` is JAX's factory.
JAX's shard_map takes q, k, v with the sequence split over the axis and
every head on each device, and GSPMD reshards from its tp rules' head
split at the boundary; Ulysses's first all-to-all then reshards sequence
-> heads, so the two compose to the identity.  The port's tp is
Megatron on heads: a tp-placed model hands the attention function its
own heads over the whole sequence (ops/ring_flash._mesh_attention_fn),
which is already what the exchange would give it.  So over tp the
factory runs exact attention on the rank's heads with no exchange, and
in one process on every head, keeping JAX's checks (the heads divide
the axis, kv broadcast where the kv heads do not, the window).
"""
from __future__ import annotations

from typing import Optional

import torch

from tf_operator_tpu_torch.ops.flash_attention import (
    check_gqa_shapes, flash_attention)
from tf_operator_tpu_torch.parallel import comm


def _local_attention(q, k, v, causal: bool, group: int, use_flash: bool,
                     window) -> torch.Tensor:
    """Exact attention over the whole sequence: the flash kernel (K2,
    GQA-native) or the einsum reference over kv broadcast to the query
    heads."""
    if use_flash:
        return flash_attention(q, k, v, causal, window=window)
    from tf_operator_tpu_torch.models.transformer import (
        dot_product_attention)

    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    return dot_product_attention(q, k, v, causal, window=window)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = False, *, group=None,
                      axis_name: str = "tp", use_flash: bool = False,
                      window: Optional[int] = None) -> torch.Tensor:
    """q [B, S_local, H, D] and k, v [B, S_local, KV, D], the sequence
    split over the ranks of `group` (None: one member, the whole
    sequence), member i holding block i.  Requires H divisible by the
    group's size.

    use_flash routes the post-exchange full-sequence attention through
    the flash kernel (ops/flash_attention: K2 on the card, its plain
    version on the CPU): Ulysses computes EXACT attention per local head
    subset, so the kernel drops in unchanged.

    Grouped-query attention: k/v may carry KV < H heads.  When KV % n ==
    0 the compact kv rides the all-to-alls (a contiguous head split keeps
    each query head with its kv head, so the local attention is plain
    GQA at the same group ratio); otherwise kv is broadcast to H heads
    before the exchange.  A sliding window needs global positions, and
    after the exchange every position is global."""
    n = 1 if group is None else torch.distributed.get_world_size(group)
    h = q.shape[2]
    g = check_gqa_shapes(q, k, v)
    if h % n:
        raise ValueError(f"heads {h} not divisible by axis {axis_name!r}={n}")
    if g > 1 and k.shape[2] % n:
        # kv heads don't split over the axis: fall back to broadcast
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
        g = 1

    # all-to-all #1: scatter heads, gather sequence -> [B, S, Hx/n, D]
    def fwd(x):
        return comm.exchange(x, group, 2, 1)

    out = _local_attention(fwd(q), fwd(k), fwd(v), causal, g, use_flash,
                           window)
    # all-to-all #2: scatter sequence, gather heads -> [B, S/n, H, D]
    return comm.exchange(out, group, 1, 2)


def make_ulysses_attention_fn(mesh, axis_name: str = "tp",
                              batch_axes=("dcn", "dp", "fsdp"),
                              use_flash: bool = False):
    """An attention_fn for the model configs, JAX's
    make_ulysses_attention_fn (module docstring): exact attention on
    what the model hands it — in a job over tp > 1 the rank's heads of a
    tp-placed model (`tp_heads`: models/llama passes its n_kv_heads),
    else every head — with JAX's checks against the axis of n members.
    The batch needs nothing: each rank already holds its data member's
    rows, which is what `batch_axes` splits in JAX."""
    n = mesh.shape[axis_name]
    tp_heads = axis_name == "tp" and n > 1 and mesh.in_job

    def attention_fn(q, k, v, causal: bool, window=None,
                     n_kv_heads: Optional[int] = None) -> torch.Tensor:
        heads = q.shape[2] * (n if tp_heads else 1)
        g = check_gqa_shapes(q, k, v)
        if heads % n:
            raise ValueError(
                f"heads {heads} not divisible by axis {axis_name!r}={n}")
        return _local_attention(q, k, v, causal, g, use_flash, window)

    # compact-kv (GQA) inputs are taken unexpanded
    attention_fn.supports_gqa = True
    attention_fn.tp_heads = tp_heads
    return attention_fn
