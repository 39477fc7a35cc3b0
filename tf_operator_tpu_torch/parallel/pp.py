"""Pipeline parallelism: the GPipe microbatch schedule over the pp mesh
axis.

The port of tf_operator_tpu/parallel/pp.py (`stack_stage_params`,
`gpipe`, `_stage_out_struct_aux`, `make_pipeline_fn`).  Stage parameters
carry a leading stage dim; the schedule runs n_micro + n_stages - 1
ticks: each tick stage 0 takes microbatch clip(t), every stage runs its
block on what it holds, and each stage's output hops to the next, so
after the fill every stage computes at once and the outputs drain from
the last.  Stage s computes microbatch t - s at tick t; outside
[0, n_micro) it computes on fill or drain garbage, as JAX's scan does,
and nothing of that reaches the outputs or the aux.

The schedule is written once, SPMD over the stages a process holds, on
the sequence ring's two forms (parallel/ring):

  - LocalRing(n): every stage in one process (the leaves' stage dim is
    n); a hop re-indexes the stages' outputs;
  - ProcessRing(mesh.group("pp")): one stage per rank (the leaves' stage
    dim is 1: the rank's block under the "pp" spec, with its tp / fsdp /
    ep blocks under `param_specs`, as parallel/mesh.shard_of cuts them).
    A hop is one rotation (parallel/comm.send_recv, an all-to-all with
    one non-empty chunk each way; gloo's point-to-point sends refuse
    CUDA tensors): stage i's output goes to stage i + 1, and the last
    stage's to stage 0, which masks it away as JAX's `jnp.where(stage
    == 0, feed, buf)` masks the zeros `ppermute` gives it.  Its backward
    rotates the gradient the other way.  The last stage's outputs reach
    every stage by `comm.reduce_forward` of the masked outputs (the
    masked psum; the gradient goes back whole), and the batch enters by
    `comm.reduce_backward` (its gradient, which only stage 0's feeds
    carry, summed over the stages), so the embedding and head that run
    outside the pipeline get their whole gradients on every stage.

The backward is autograd's.  Every rank builds the same graph: each
stage-dependent choice is a tensor (the feed's `where`, the outputs' and
the aux's masks), never a Python branch, and every tick runs on every
stage.  Each tick's backward hop needs the gradient of the next tick's
input, so the hops' backward runs tick by tick from the last, and the
collectives inside a stage (tp, fsdp, ep) run between them in the same
order on every rank: every rank issues the same sequence of collectives,
which cannot deadlock.  Every stage's parameters must require a
gradient alike (all or none).

Data axes: a rank of the process form holds its data member's rows
(`data_rows`: each microbatch's chunk of the member, the layout
make_pipeline_fn's batch spec P(None, batch_axes) gives JAX's devices);
after the backward `reduce_gradients_` sums each leaf's gradient over
the data axes it is not sharded over and divides by the members, the
global batch's mean.  In one process the batch is the global one.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Tuple

import torch

from tf_operator_tpu_torch.parallel import comm
from tf_operator_tpu_torch.parallel.mesh import (
    AXIS_ORDER, Mesh, Spec, shard_of, spec_mesh_axes)
from tf_operator_tpu_torch.parallel.ring import LocalRing, ProcessRing


# ------------------------------------------------------------- trees
def tree_map(fn: Callable, *trees):
    """fn over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves_with_path(tree, prefix: Tuple = ()):
    """[(path, leaf)] of nested dicts, keys sorted (jax.tree_util's
    order)."""
    if isinstance(tree, dict):
        return [item for k, v in sorted(tree.items())
                for item in leaves_with_path(v, prefix + (k,))]
    return [(prefix, tree)]


def keystr(path: Tuple) -> str:
    """jax.tree_util.keystr of a dict path: "['stages']['wq']"."""
    return "".join(f"[{k!r}]" for k in path)


def named_leaves(tree) -> Dict[str, Any]:
    """{"stages.wq": leaf, ...}: a tree's leaves by dotted path, the flat
    form runtime/optim's optimizers take."""
    return {".".join(p): leaf for p, leaf in leaves_with_path(tree)}


def place(tree, specs, mesh: Mesh):
    """This rank's block of each whole leaf of `tree` under its spec in
    the tree `specs` (a fresh contiguous tensor)."""
    return tree_map(lambda x, s: shard_of(x, s, mesh).clone(), tree, specs)


def stack_stage_params(params_list) -> Any:
    """[per-stage trees] -> one tree with a leading stage dim, ready to
    shard with the spec ("pp", ...)."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *params_list)


# ---------------------------------------------------------- schedule
def _stage_out_struct_aux(run_stage, members, inputs, x_dtype):
    """The first tick's stage outputs, and the carry dtype: the fixed
    point of input-dtype promotion (a bf16 batch through f32 params
    carries f32), found by running the tick again in the promoted dtype
    until the outputs' dtype promotes to the inputs'.  Stages must be
    shape-preserving across hops.  run_stage: (params, inp) -> (y,
    aux); inputs(dtype) gives each held stage's first input."""
    dt = x_dtype
    while True:
        outs = [run_stage(p, inp) for p, inp in zip(members, inputs(dt))]
        y = outs[0][0]
        promoted = torch.promote_types(dt, y.dtype)
        if promoted == dt:
            return outs, dt
        dt = promoted


def gpipe(stage_fn: Callable, params, x: torch.Tensor, *, ring=None,
          axis_name: str = "pp", has_aux: bool = False,
          aux_mean_group=None):
    """Run the pipeline over `ring` (default every stage in this
    process: LocalRing of the params' stage dim):
      params — the held stages' slices, leading dim len(ring.members)
               (a ProcessRing: this rank's stage, leading dim 1)
      x      — microbatched input [n_micro, mb, ...], the same on every
               stage
    Returns [n_micro, mb, ...] outputs, on every stage.

    has_aux: stage_fn returns (y, aux_scalar), e.g. an MoE load-balance
    loss.  Each stage accumulates aux only on its valid ticks, the
    per-stage sums are summed over the stages (the total over stages ×
    microbatches), then averaged over the ranks of `aux_mean_group`
    (the data members, each of which saw other tokens: the value is the
    mean, the gradient this member's own share).  Returns (outputs,
    aux_total)."""
    if ring is None:
        leaf = leaves_with_path(params)[0][1]
        ring = LocalRing(leaf.shape[0] if leaf.dim() else 1)
    n_stages = ring.size
    for path, leaf in leaves_with_path(params):
        if leaf.dim() == 0 or leaf.shape[0] != len(ring.members):
            stages = ("a scalar (no stage dim)" if leaf.dim() == 0
                      else leaf.shape[0])
            raise ValueError(
                f"gpipe: per-device param {keystr(path)} carries "
                f"{stages}; the stacked stage dim must equal the "
                f"{axis_name!r} axis size ({n_stages})")
    members = [tree_map(lambda p, j=j: p[j], params)
               for j in range(len(ring.members))]
    if isinstance(ring, ProcessRing):
        # only stage 0's feeds carry the batch's gradient: summed over
        # the stages, every stage's embedding gets it whole
        x = comm.reduce_backward(x, ring.group)
    n_micro = x.shape[0]
    ticks = n_micro + n_stages - 1
    dev = x.device
    # per held stage: is it the first, is it the last (tensors, so every
    # rank's graph is the same)
    first = [torch.tensor(s == 0, device=dev) for s in ring.members]
    last = [float(s == n_stages - 1) for s in ring.members]

    def run_stage(p, inp):
        if has_aux:
            return stage_fn(p, inp)
        return stage_fn(p, inp), None

    def inputs(t, bufs, dt):
        feed = x[min(t, n_micro - 1)].to(dt)
        return [torch.where(f, feed, b.to(dt)) for f, b in zip(first, bufs)]

    zero = torch.zeros(x.shape[1:], dtype=x.dtype, device=dev)
    outs, carry = _stage_out_struct_aux(
        run_stage, members, lambda dt: inputs(0, [zero] * len(members), dt),
        x.dtype)
    if tuple(outs[0][0].shape) != tuple(x.shape[1:]):
        raise ValueError(
            f"gpipe: stage output shape {tuple(outs[0][0].shape)} != input "
            f"{tuple(x.shape[1:])}; stages must be shape-preserving")
    aux_acc = [torch.zeros((), dtype=torch.float32, device=dev)
               for _ in members]
    drained = [[] for _ in members]
    for t in range(ticks):
        if t:
            outs = [run_stage(p, inp) for p, inp in
                    zip(members, inputs(t, bufs, carry))]
        ys = [y for y, _ in outs]
        if has_aux:
            # this stage computes microbatch t - s; outside [0, n_micro)
            # it chews fill/drain garbage and the aux is masked
            aux_acc = [acc + torch.where(
                torch.tensor(0 <= t - s < n_micro, device=dev),
                aux.to(torch.float32), 0.0)
                for acc, (_, aux), s in zip(aux_acc, outs, ring.members)]
        if t >= n_stages - 1:   # microbatch t - (n - 1) drains
            for j, y in enumerate(ys):
                drained[j].append(y)
        if t < ticks - 1:
            bufs = [b for (b,) in ring.rotate([(y,) for y in ys], 1)]
    # only the last stage holds real outputs: a masked sum over the stages
    out = _stage_sum(ring, [torch.stack(d) * m
                            for d, m in zip(drained, last)])
    if not has_aux:
        return out
    aux_total = _stage_sum(ring, aux_acc)
    return out, _member_mean(aux_total, aux_mean_group)


def _stage_sum(ring, parts: list) -> torch.Tensor:
    """The sum of every stage's part, on every stage."""
    if isinstance(ring, ProcessRing):
        (part,) = parts
        return comm.reduce_forward(part, ring.group)
    return sum(parts[1:], parts[0])


def _member_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of `t` over the ranks of `group`, whose gradient reaches
    this rank's own `t` unscaled (a mean of the members' gradients then
    gives the global one)."""
    if group is None:
        return t
    total = t.detach().clone()
    comm.all_reduce_(total, group)
    return t + (total / torch.distributed.get_world_size(group)
                - t).detach()


# ------------------------------------------------------------- runner
def _batch_axes(batch_axes) -> Tuple[str, ...]:
    if batch_axes is None:
        return ()
    if isinstance(batch_axes, str):
        return (batch_axes,)
    return tuple(batch_axes)


def data_group(mesh: Mesh, batch_axes):
    """The process group of this rank's data members over `batch_axes`
    (None outside a job or where they are one)."""
    axes = tuple(a for a in AXIS_ORDER if a in _batch_axes(batch_axes))
    return mesh.group(axes) if mesh.in_job and axes else None


def data_rows(batch: torch.Tensor, mesh: Mesh, n_micro: int,
              batch_axes) -> torch.Tensor:
    """This rank's rows of a global batch [B, ...] as make_pipeline_fn
    splits it over `batch_axes`: each of the n_micro microbatches' chunk
    at the rank's index along them (the first axis major), microbatch by
    microbatch."""
    axes = _batch_axes(batch_axes)
    n = mesh.axis_size(axes)
    i = mesh.axis_index(axes)
    mb = batch.shape[0] // n_micro
    w = mb // n
    x = batch.reshape((n_micro, mb) + tuple(batch.shape[1:]))
    return x[:, i * w:(i + 1) * w].reshape((n_micro * w,)
                                           + tuple(batch.shape[1:]))


def make_pipeline_fn(mesh: Mesh, stage_fn, n_micro: int,
                     axis_name: str = "pp", param_specs=None,
                     batch_axes=None, has_aux: bool = False):
    """f(stacked_params, batch) running the pipeline over `mesh`: the
    stages over `axis_name`'s ranks in a job (mesh.in_job), or every
    stage in this process.  `stacked_params` leaves are [n_stages, ...]
    in one process, this rank's blocks (stage dim 1) in a job; batch
    [B, ...] (in a job: this rank's rows, `data_rows`) is split into
    n_micro microbatches.

    param_specs: the spec tree of the stacked params, JAX's argument
    (shard_map's in_specs); a rank of the port is handed its blocks
    already cut by it (`place`), so nothing here reads it.  batch_axes:
    mesh axis (or tuple) the microbatch dim is split over (data
    parallelism inside the pipeline); default replicated.  has_aux: stage_fn returns (y,
    aux_scalar); f returns (out, aux_total) with aux summed over stages
    × microbatches and averaged over the data members (see gpipe)."""
    if batch_axes is not None:
        batch_axes = _batch_axes(batch_axes)
        missing = [a for a in batch_axes if a not in mesh.shape]
        if missing:
            raise ValueError(
                f"batch_axes {missing} not in mesh axes "
                f"{tuple(mesh.shape)} (batch_axes must name mesh axes to "
                f"shard the microbatch dim over)")
        dp_total = math.prod(mesh.shape[a] for a in batch_axes)
    else:
        dp_total = 1
    pp = mesh.shape[axis_name]
    group = mesh.group(axis_name) if mesh.in_job else None
    ring = ProcessRing(group) if group is not None else LocalRing(pp)
    if group is not None and ring.rank != mesh.coords()[axis_name]:
        raise AssertionError(f"stage {ring.rank} is not the rank's "
                             f"{axis_name} coordinate {mesh.coords()}")
    members = data_group(mesh, batch_axes)
    # a rank of a job holds its data member's rows
    local = dp_total if mesh.in_job else 1

    def run(params, batch):
        b = batch.shape[0] * local
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
        if (b // n_micro) % dp_total:
            raise ValueError(
                f"microbatch {b // n_micro} not divisible by the batch mesh "
                f"axes {batch_axes} (total {dp_total})")
        for path, leaf in leaves_with_path(params):
            if leaf.dim() == 0 or leaf.shape[0] != len(ring.members):
                # a rank's block holds 1 / pp of the stacked stages
                stages = ("a scalar (no stage dim)" if leaf.dim() == 0
                          else leaf.shape[0] * pp // len(ring.members))
                raise ValueError(
                    f"make_pipeline_fn: stacked param {keystr(path)} has "
                    f"{stages} stages but mesh axis {axis_name!r} has {pp} "
                    f"devices; they must match (one stage per pipeline "
                    f"device)")
        bl = batch.shape[0]
        x = batch.reshape((n_micro, bl // n_micro) + tuple(batch.shape[1:]))
        out = gpipe(stage_fn, params, x, ring=ring, axis_name=axis_name,
                    has_aux=has_aux, aux_mean_group=members)
        if has_aux:
            out, aux = out
            return out.reshape((bl,) + tuple(out.shape[2:])), aux
        return out.reshape((bl,) + tuple(out.shape[2:]))

    return run


# ------------------------------------------------------- the step
@torch.no_grad()
def reduce_gradients_(params: Mapping[str, torch.Tensor],
                      specs: Mapping[str, Spec], mesh: Mesh,
                      batch_axes) -> None:
    """After the backward of a rank's data member's loss: each leaf's
    .grad summed over the data axes (`batch_axes`) it is not sharded
    over (an fsdp-sharded leaf's gradient already sums over fsdp in its
    gather's backward, an ep block's over ep in the dispatch's) and
    divided by the number of data members: the global batch's mean
    gradient.  A leaf without a gradient takes zeros first, so every
    rank sends the same buckets.  Nothing outside a job."""
    from tf_operator_tpu_torch.parallel.placement import _bucketed

    axes = _batch_axes(batch_axes)
    n = mesh.axis_size(axes)
    if not mesh.in_job or n == 1:
        return
    by_axes: Dict[Tuple[str, ...], list] = {}
    for k, p in params.items():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        over = tuple(a for a in AXIS_ORDER
                     if a in axes and a not in spec_mesh_axes(specs[k]))
        by_axes.setdefault(over, []).append(p.grad)
    for over, grads in by_axes.items():
        _bucketed(grads, mesh.group(over))
        for g in grads:
            g.div_(n)


def mean_over_data(t: torch.Tensor, mesh: Mesh, batch_axes
                   ) -> torch.Tensor:
    """A detached copy of a data member's `t` (a loss) averaged over the
    members: the global batch's mean."""
    out = t.detach().clone()
    group = data_group(mesh, batch_axes)
    if group is None:
        return out
    comm.all_reduce_(out, group)
    return out / torch.distributed.get_world_size(group)
