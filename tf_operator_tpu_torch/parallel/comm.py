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
its slice.  The rule between the two: a gather whose downstream every
member computes alike (one loss, replicated) keeps the rank's slice in
its backward; one whose members go on to different losses (their own
rows) sums.  `take_chunk` is the transpose of the first: this rank's
chunk forward, the members' gradients gathered backward (a replicated
input to a partitioned computation).

`reduce_forward` and `reduce_backward` are g and f over any group
(the pipeline's over pp: parallel/pp).  `exchange` is the autograd
all-to-all over a group: each member's tensor split along one dim,
chunk j sent to member j, the chunks received laid side by side along
another dim; its backward is the all-to-all the other way.  It turns Megatron's local heads
[B, S, H/n, D] into a sequence block of every head [B, S/n, H, D] for
the ring over tp (ops/ring_flash), and carries the expert buckets of
expert parallelism (parallel/ep).

Every collective here goes through `all_reduce_`, `all_gather_cat`,
`reduce_scatter_dim` or `all_to_all`; gloo runs each of them on CUDA
tensors too (two ranks sharing one card, where NCCL refuses;
chip_smoke's probe reads them), so none is staged through the host.
gloo's point-to-point sends do not take CUDA tensors, so a ring's
rotation (parallel/ring.ProcessRing) is an all-to-all whose only
non-empty chunk goes to the peer.  `STATS` sums their calls, bytes
and, while `STATS["timing"]` is set, their seconds on the host clock
(the card synchronized around each, so the time is the collective's
alone), in all and for each kind in `STATS["kinds"]`.
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, Optional

import torch
import torch.distributed as dist

STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "timing": False,
         "kinds": {}}


def reset_stats(timing: Optional[bool] = None) -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0, kinds={})
    if timing is not None:
        STATS["timing"] = timing


def _timed(t: torch.Tensor, run: Callable, kind: str):
    """run() counted under `kind` (calls, `t`'s bytes, and its seconds
    while timing)."""
    nbytes = t.numel() * t.element_size()
    mine = STATS["kinds"].setdefault(kind, {"calls": 0, "bytes": 0,
                                            "seconds": 0.0})
    for rec in (STATS, mine):
        rec["calls"] += 1
        rec["bytes"] += nbytes
    if not STATS["timing"]:
        return run()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = run()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    dt = time.perf_counter() - t0
    STATS["seconds"] += dt
    mine["seconds"] += dt
    return out


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """Reduce `t` over `group` in place (None: nothing to do)."""
    if group is None:
        return t

    def run():
        dist.all_reduce(t, op=op, group=group)
        return t

    return _timed(t, run, "all_reduce")


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

    return _timed(t, run, "all_gather")


def reduce_scatter_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over `group` of every member's `t`, of which this rank
    keeps its chunk along `dim` (chunk i to group rank i)."""
    n = dist.get_world_size(group)
    w = t.shape[dim] // n
    # [n, *chunk]: member i's chunk first-major, as reduce_scatter wants
    src = t.unflatten(dim, (n, w)).movedim(dim, 0).contiguous()

    def run():
        out = torch.empty(src[0].numel(), dtype=t.dtype, device=t.device)
        _quiet(dist.reduce_scatter_tensor, out, src.reshape(-1), group=group)
        return out.view(src.shape[1:])

    return _timed(t, run, "reduce_scatter")


def all_to_all(t: torch.Tensor, group, split_dim: int, cat_dim: int
               ) -> torch.Tensor:
    """`t` split along `split_dim` into one chunk per member of `group`,
    chunk j sent to member j; returns the chunks received, member i's
    first-major, side by side along `cat_dim` (None: `t`)."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    w = t.shape[split_dim] // n
    if w * n != t.shape[split_dim]:
        raise ValueError(f"dim {split_dim} of {tuple(t.shape)} does not "
                         f"split over {n} members")
    # [n, *chunk]: chunk j first-major, as all_to_all_single sends it
    src = t.unflatten(split_dim, (n, w)).movedim(split_dim, 0).contiguous()

    def run():
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
        return torch.cat(out.unbind(0), dim=cat_dim)

    return _timed(src, run, "all_to_all")


def send_recv(t: torch.Tensor, group, dst: int, src: int) -> torch.Tensor:
    """`t` sent to group rank `dst` while a tensor of t's shape arrives
    from group rank `src`: an all-to-all whose one non-empty chunk each
    way is the peer's (gloo's isend/irecv refuse CUDA tensors)."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    out = torch.empty_like(t)

    def run():
        dist.all_to_all_single(
            out.reshape(-1), t.reshape(-1),
            [t.numel() if j == src else 0 for j in range(n)],
            [t.numel() if j == dst else 0 for j in range(n)], group=group)
        return out

    return _timed(t, run, "send_recv")


def _chunk(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    w = t.shape[dim] // n
    return t.narrow(dim, dist.get_rank(group) * w, w)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.group, ctx.dims = group, (split_dim, cat_dim)
        return all_to_all(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return (all_to_all(g.contiguous(), ctx.group, cat_dim, split_dim),
                None, None, None)


def exchange(x: torch.Tensor, group, split_dim: int, cat_dim: int
             ) -> torch.Tensor:
    """all_to_all under autograd: the backward sends the gradient's
    chunks back the way they came."""
    if group is None:
        return x
    return _Exchange.apply(x, group, split_dim % x.dim(), cat_dim % x.dim())


class _TakeChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g.contiguous(), ctx.group, ctx.dim), None, None


def take_chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk along `dim` of `x`, which every member of
    `group` holds alike; the backward gathers the members' chunk
    gradients, the whole gradient of the shared input."""
    if group is None:
        return x
    return _TakeChunk.apply(x, group, dim % x.dim())


def gather_out(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every member's `x` side by side along `dim`, for a computation
    every member then runs alike: the backward keeps this rank's slice."""
    if group is None:
        return x
    return _GatherOut.apply(x, group, dim % x.dim())


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


def reduce_forward(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every member's `x` (each holds a part), whose gradient
    each member takes whole: Megatron's g over any group, as `Tp.exit`."""
    if group is None:
        return x
    return _Exit.apply(x, group)


def reduce_backward(x: torch.Tensor, group) -> torch.Tensor:
    """`x` unchanged, whose gradient is the sum of every member's:
    Megatron's f over any group, as `Tp.enter`."""
    if group is None:
        return x
    return _Enter.apply(x, group)


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
        return reduce_backward(x, self.group)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_forward(x, self.group)

    def gather_out(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return gather_out(x, self.group, dim)

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
