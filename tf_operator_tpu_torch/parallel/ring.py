"""The sequence ring: the port's counterpart of `shard_map` over one mesh
axis with `jax.lax.ppermute`, `axis_index` and `psum`.

A ring has `size` members, numbered 0..size-1.  A process holds some of
them (`members`, in order); ring code is written once, SPMD over the
members this process holds, and each member keeps its own shards in a
list indexed like `members`.  `rotate(shards, hop)` moves every member's
shards `hop` places around the ring in one exchange: member i's shards go
to member (i + hop) % size, as `ppermute` with pairs (i, (i + hop) % n)
does (tf_operator_tpu/ops/ring_attention.py `rotate_shards`).

  - LocalRing(n): all n members in this process, on one device.  A
    rotation re-indexes the member list; nothing is copied.  The kernels
    run exactly as on n cards: one launch per (member, live step).
  - ProcessRing(group): one member per rank of a torch.distributed
    process group (gloo on the CPU or on CUDA tensors, NCCL on cards),
    member i the group's rank i.  A group a mesh makes over one axis
    (parallel/mesh.Mesh.group) lists its ranks in order, so member i is
    the rank at coordinate i along that axis, as `ppermute` numbers the
    devices of a `shard_map` axis.  A rotation is one exchange
    (parallel/comm.send_recv: an all-to-all whose only non-empty chunks
    are a send to member (i + hop) % n and a receive from (i - hop) % n;
    gloo's isend/irecv refuse CUDA tensors); under autograd its backward
    rotates by -hop (the transpose of ppermute).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from tf_operator_tpu_torch.parallel import comm

Shards = List[Tuple[torch.Tensor, ...]]


class LocalRing:
    """n ring members in one process."""

    def __init__(self, n: int) -> None:
        if n < 1:
            raise ValueError(f"a ring needs at least one member, got {n}")
        self.size = n
        self.members = tuple(range(n))

    def rotate(self, shards: Shards, hop: int) -> Shards:
        n = self.size
        if len(shards) != n:
            raise ValueError(f"{len(shards)} shard sets for {n} members")
        # member j receives what member j - hop held
        return [shards[(j - hop) % n] for j in range(n)]

    def __repr__(self) -> str:
        return f"LocalRing({self.size})"


class _Exchange(torch.autograd.Function):
    """One ring exchange of a tuple of tensors; backward sends the
    gradients the other way."""

    @staticmethod
    def forward(ctx, ring, hop, *tensors):
        ctx.ring, ctx.hop = ring, hop
        return ring._exchange(tensors, hop)

    @staticmethod
    def backward(ctx, *grads):
        # autograd hands missing gradients over as zeros
        return (None, None) + ctx.ring._exchange(grads, -ctx.hop)


class ProcessRing:
    """One ring member per rank of `group` (None: the default group)."""

    def __init__(self, group=None) -> None:
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.members = (self.rank,)

    def peer(self, offset: int) -> int:
        """The global rank of the member `offset` places on."""
        peer = (self.rank + offset) % self.size
        return (peer if self.group is None
                else dist.get_global_rank(self.group, peer))

    def _exchange(self, tensors: Sequence[torch.Tensor], hop: int):
        if hop % self.size == 0:
            return tuple(t.clone() for t in tensors)
        n = self.size
        dst, src = (self.rank + hop) % n, (self.rank - hop) % n
        # one exchange for every tensor of one dtype, laid end to end
        out = [None] * len(tensors)
        by_dtype = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            got = comm.send_recv(flat, self.group, dst, src)
            offset = 0
            for i in idx:
                t = tensors[i]
                out[i] = got[offset:offset + t.numel()].view(t.shape)
                offset += t.numel()
        return tuple(out)

    def rotate(self, shards: Shards, hop: int) -> Shards:
        if len(shards) != 1:
            raise ValueError(f"{len(shards)} shard sets for one member")
        return [_Exchange.apply(self, hop, *shards[0])]

    def __repr__(self) -> str:
        return f"ProcessRing(rank {self.rank} of {self.size})"
