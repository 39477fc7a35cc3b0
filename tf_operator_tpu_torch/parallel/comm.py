"""The collectives of a sharded step, and the autograd functions that
carry them.

Tensor parallelism runs Megatron-style on each rank's slices of the
weights (parallel/placement); the tp collectives are two autograd
functions at the edges of each parallel region:

  - `Tp.enter` at a column-parallel input: identity forward, all-reduce
    of the gradient over tp backward (each rank's gradient of the input
    is the part its slice of the weights sees);
  - `Tp.exit` after a row-parallel output: all-reduce forward (each
    rank holds a partial sum), identity backward.

`Tp.gather_out` gathers a vocab-parallel output (the logits) along a dim
for a loss every tp rank then computes whole: the backward keeps this
rank's slice of the gradient.  `gather_param` is fsdp's just-in-time
gather of a sharded weight: all-gather forward, and backward the sum of
every member's gradient of the whole weight, of which this rank keeps
its slice.

Every collective here goes through `all_reduce_`, `all_gather_cat` or
`reduce_scatter_dim`; gloo runs each of them on CUDA tensors too (two
ranks sharing one card, where NCCL refuses; chip_smoke's probe reads
them), so none is staged through the host.  `STATS` sums their calls,
bytes and, while `STATS["timing"]` is set, their seconds on the host
clock (the card synchronized around each, so the time is the
collective's alone).
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, Optional

import torch
import torch.distributed as dist

STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "timing": False}


def reset_stats(timing: Optional[bool] = None) -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0)
    if timing is not None:
        STATS["timing"] = timing


def _timed(t: torch.Tensor, run: Callable):
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    if not STATS["timing"]:
        return run()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = run()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    STATS["seconds"] += time.perf_counter() - t0
    return out


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """Reduce `t` over `group` in place (None: nothing to do)."""
    if group is None:
        return t

    def run():
        dist.all_reduce(t, op=op, group=group)
        return t

    return _timed(t, run)


def _quiet(fn, *args, **kwargs):
    """A collective whose name newer torch versions deprecate (they warn
    at every call)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every member's `t` concatenated along `dim`, in group rank order
    (None: `t`): one all_gather_into_tensor into [n, *t.shape], then the
    members' blocks laid side by side along `dim`."""
    if group is None:
        return t
    t = t.contiguous()

    def run():
        n = dist.get_world_size(group)
        buf = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
        _quiet(dist.all_gather_into_tensor, buf, t.reshape(-1), group=group)
        buf = buf.view((n,) + tuple(t.shape))
        if dim == 0:
            return buf.reshape((n * t.shape[0],) + tuple(t.shape[1:]))
        return torch.cat(buf.unbind(0), dim=dim)

    return _timed(t, run)


def reduce_scatter_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over `group` of every member's `t`, of which this rank
    keeps its chunk along `dim` (chunk i to group rank i)."""
    n = dist.get_world_size(group)
    w = t.shape[dim] // n
    # [n, *chunk]: member i's chunk first-major, as reduce_scatter wants
    src = t.unflatten(dim, (n, w)).movedim(dim, 0).contiguous()

    def run():
        out = torch.empty(src[0].numel(), dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, src.reshape(-1), group=group)
        return out.view(src.shape[1:])

    return _timed(t, run)


def _chunk(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    w = t.shape[dim] // n
    return t.narrow(dim, dist.get_rank(group) * w, w)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group, ctx.dim).contiguous(), None, None


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(w, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.group, ctx.dim), None, None


def gather_param(w: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The whole of a weight sharded along `dim` over `group`; its
    gradient sums over the group and returns to each rank's shard."""
    if group is None:
        return w
    return _GatherParam.apply(w, group, dim)


class Tp:
    """A tensor-parallel group as the model's modules use it: `size`
    ranks, this one `rank` of them."""

    def __init__(self, group, rank: int, size: int) -> None:
        self.group, self.rank, self.size = group, rank, size

    def __repr__(self) -> str:
        return f"Tp({self.rank}/{self.size})"

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return _Exit.apply(x, self.group)

    def gather_out(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return _GatherOut.apply(x, self.group, dim % x.dim())

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                    ) -> torch.Tensor:
        return all_reduce_(t, self.group, op)


def vocab_parallel_embedding(idx: torch.Tensor, table: torch.Tensor,
                             tp: Tp, lookup: Callable = None
                             ) -> torch.Tensor:
    """`lookup(ids, table)` (default F.embedding) over a table whose rows
    (the vocab) are split over tp: each rank looks up the ids in its
    slice, zeros elsewhere, and the sum over tp (one rank non-zero a
    token) is the whole lookup."""
    v = table.shape[0]
    local = idx - tp.rank * v
    mine = (local >= 0) & (local < v)
    rows = (lookup or torch.nn.functional.embedding)(
        local.clamp(0, v - 1), table)
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return tp.exit(rows)
