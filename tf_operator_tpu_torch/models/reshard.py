"""Checkpoint resharding across mesh shapes: the elastic-resize middle.

The port of tf_operator_tpu/models/reshard.py.  An elastic resize
(drain -> reshard -> resume) changes the number of ranks, and so the mesh
the training state lives on.  The JAX package's orbax checkpoint holds
the old mesh's shards, so its reshard loads at the old sharding, gathers
to the host and saves at the new mesh's shardings.  The port's
Checkpointer (runtime/train) writes every leaf whole (a sharded state is
gathered leaf by leaf to the writing rank, and a restore keeps each
rank's block of the whole leaf), so a checkpoint already moves between
any two meshes; what resharding keeps here is the move's contract:

  - ONE placement rule, `state_shardings` (parallel/mesh.pick_fsdp_dim,
    the rule runtime/train and parallel/tp share): every large leaf,
    params and the optimizer moments shaped like them, along its largest
    fsdp-divisible dim; small leaves and scalars replicate.  A resumed
    job places its model by it (parallel/placement.place with its
    .params) and pins its step to it (make_train_step(state_shardings=)).
  - failure atomicity: `reshard_checkpoint` reads the source step and
    never writes the source; it checks that every leaf places on the new
    mesh, then writes the destination step as the Checkpointer writes
    (a temporary directory renamed into place, fsynced), overwriting a
    half-written destination step on a re-run.  Until the controller's
    phase advances, the destination is scratch.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch

from tf_operator_tpu_torch.parallel.mesh import (
    Mesh, pick_fsdp_dim, shard_of, shard_slices)
from tf_operator_tpu_torch.parallel.tp import StateSharding
from tf_operator_tpu_torch.runtime.train import (
    PARAMS_FILE, STATE_FILE, TrainState, write_step)


def _whole_shape(x, spec, mesh: Mesh):
    """The whole shape of a leaf this rank holds the block of."""
    return tuple(n * mesh.axis_size(e) for n, e in
                 zip(x.shape, tuple(spec) + (None,) * (x.dim() - len(spec))))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def state_shardings(tree: Any, mesh: Mesh, min_size: int = 2**14) -> Any:
    """The spec of every leaf of a whole train state on `mesh`: every
    large leaf (params AND the optimizer moments shaped like them) shards
    along its largest fsdp-divisible dim, small leaves and scalars
    replicate.  A TrainState gives a parallel/tp.StateSharding (a sharded
    one is read at its whole shapes); nested dicts of tensors the same
    tree of specs."""
    fsdp = mesh.shape.get("fsdp", 1)

    def place(shape):
        d = pick_fsdp_dim(tuple(shape), fsdp, min_size)
        if d is None:
            return ()
        spec = [None] * len(shape)
        spec[d] = "fsdp"
        return tuple(spec)

    def leaf(x):
        return place(getattr(x, "shape", ()) or ())

    if isinstance(tree, TrainState):
        lay = tree.layout
        if lay is None:
            return StateSharding(step=(), params=_map(leaf, tree.params),
                                 opt_state=_map(leaf, tree.opt_state),
                                 batch_stats=_map(lambda _: (),
                                                  tree.batch_stats))
        params = {k: place(lay.shape(k, p)) for k, p in tree.params.items()}
        opt = _zip(lambda x, s: place(_whole_shape(x, s, lay.mesh))
                   if isinstance(x, torch.Tensor) else (),
                   tree.opt_state, lay.opt_specs)
        return StateSharding(step=(), params=params, opt_state=opt,
                             batch_stats=_map(lambda _: (),
                                              tree.batch_stats))
    return _map(leaf, tree)


def _zip(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def host_gather(tree: Any) -> Any:
    """Every leaf whole on the host: the explicit gather between "held at
    the old sharding" and "placed at the new".  A sharded TrainState
    (its layout: parallel/placement) is gathered as Checkpointer.save
    gathers it, one leaf at a time over the mesh (every rank calls), and
    comes back as a TrainState of whole host tensors without a layout;
    tensors in nested dicts are copied to the host."""
    def host(x):
        return (x.detach().to("cpu", copy=True)
                if isinstance(x, torch.Tensor) else x)

    if isinstance(tree, TrainState):
        lay = tree.layout
        if lay is None:
            params, opt = _map(host, tree.params), _map(host, tree.opt_state)
        else:
            params = {k: host(lay.full(p.detach(), lay.spec(k)))
                      for k, p in tree.params.items()}
            opt = _zip(lambda x, s: host(lay.full(x, s))
                       if isinstance(x, torch.Tensor) else x,
                       tree.opt_state, lay.opt_specs)
        return TrainState(step=tree.step, params=params, opt_state=opt,
                          tx=tree.tx,
                          batch_stats=_map(host, tree.batch_stats))
    return _map(host, tree)


def place_state(tree: Any, mesh: Mesh, min_size: int = 2**14) -> Any:
    """This rank's block of every whole leaf of a host tree under
    `state_shardings(tree, mesh)` — the second half of the reshard, for
    in-memory resizes (a TrainState gives a TrainState of blocks, its
    `layout` unset: a model placed with the specs' params holds them)."""
    specs = state_shardings(tree, mesh, min_size=min_size)

    def block(x, s):
        return (shard_of(x, s, mesh).clone()
                if isinstance(x, torch.Tensor) and s else x)

    if isinstance(tree, TrainState):
        return TrainState(
            step=tree.step, params=_zip(block, tree.params, specs.params),
            opt_state=_zip(block, tree.opt_state, specs.opt_state),
            tx=tree.tx, batch_stats=dict(tree.batch_stats))
    return _zip(block, tree, specs)


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isdir(os.path.join(directory, n)))


def reshard_checkpoint(src_dir: str, dst_dir: str, new_mesh: Mesh,
                       step: Optional[int] = None,
                       min_size: int = 2**14) -> int:
    """Reshard the newest (or `step`'s) checkpoint under `src_dir` (the
    Checkpointer's layout) to `new_mesh`'s shardings, written under
    `dst_dir`; returns the step.

    The source is never touched: the resumed loop points its
    Checkpointer at `dst_dir` and restores the exact step the drain
    saved — step count preserved, params byte-equal.  Every leaf must
    place on `new_mesh` under state_shardings before anything is
    written.  A destination that already holds the step (a crash re-run)
    is overwritten: until the controller's phase annotation advances,
    the destination is scratch."""
    if not dst_dir or str(dst_dir) == str(src_dir) or (
            os.path.realpath(dst_dir) == os.path.realpath(src_dir)):
        raise ValueError(
            "reshard_checkpoint needs a destination distinct from the "
            "source: resharding in place would destroy the only durable "
            "copy mid-write — the opposite of failure-atomic")
    steps = _steps(src_dir)
    step = step if step is not None else (steps[-1] if steps else None)
    if step is None or step not in steps:
        raise ValueError(f"no checkpoint to reshard under {src_dir!r}")
    path = os.path.join(src_dir, str(step))
    params = torch.load(os.path.join(path, PARAMS_FILE), weights_only=True)
    rest = torch.load(os.path.join(path, STATE_FILE), weights_only=True)
    whole = {"params": params, "opt_state": rest["opt_state"]}
    specs = state_shardings(whole, new_mesh, min_size=min_size)
    # every leaf places on the new mesh: each rank's block divides
    _zip(lambda x, s: shard_slices(x.shape, s, new_mesh, 0)
         if isinstance(x, torch.Tensor) else None, whole, specs)
    os.makedirs(dst_dir, exist_ok=True)
    shutil.rmtree(os.path.join(dst_dir, str(step)), ignore_errors=True)
    write_step(dst_dir, step, params, rest)
    return int(step)


def reshard_shapes(old_shape: Dict[str, int], new_shape: Dict[str, int]
                   ) -> Dict[str, Any]:
    """Human/log-facing summary of a shape delta (the controller records
    it with the `resharded` decision): per-type old -> new counts plus
    the grow/shrink verdict."""
    types = sorted(set(old_shape) | set(new_shape))
    old_total = sum(old_shape.get(t, 0) for t in types)
    new_total = sum(new_shape.get(t, 0) for t in types)
    return {
        "types": {
            t: [old_shape.get(t, 0), new_shape.get(t, 0)] for t in types
        },
        "direction": (
            "grow" if new_total > old_total
            else "shrink" if new_total < old_total else "reshape"
        ),
    }
