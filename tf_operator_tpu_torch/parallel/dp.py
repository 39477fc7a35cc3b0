"""Data parallelism across processes: the port's counterpart of the JAX
package's `dp` mesh axis.

The JAX step is jitted over the GLOBAL batch sharded on dp, and XLA sums
what spans it: the gradients (tf_operator_tpu/runtime/train.py), and every
batch statistic a model takes on the way.  Here each process runs the
step on its own rows, so the port sums them itself over a process group:

  - `mean_gradients_`: after backward, every `.grad` becomes the mean over
    the ranks (one all_reduce a bucket of flattened gradients, then / n),
    so the optimizer steps identically on every rank;
  - inside `replicas(group)`, the statistics that span the batch read the
    active group (`active()`): BatchNorm's mean and variance and their
    backward (models/flax_layers), the masked-LM loss's count of masked
    positions (train_bert.mlm_loss), the MoE load-balancing loss's
    router means and selection counts (parallel/ep) and the
    expert-parallel dispatch's global token list (ep.make_switch_moe;
    models/llama decodes the rows of a cache split over the data axes
    inside it too).  Outside it everything is local, as before;
  - `replicate_`: every rank starts from rank 0's parameters.

Each rank's loss is written so that the mean of the ranks' gradients is
the gradient of the global loss; `mean_metrics` reports the global value.
Only all_reduce, broadcast and barrier are used: gloo takes CUDA tensors
for those (two ranks on one card), NCCL needs a card a rank.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Mapping, Optional

import torch
import torch.distributed as dist

from tf_operator_tpu_torch.engine.tracing import get_tracer

TRACER = get_tracer()

# the group of the step running now (replicas()); None: no data parallelism
_ACTIVE: Optional[object] = None

BUCKET_BYTES = 64 << 20


def job_group():
    """The job's process group (runtime/bootstrap) when it has more than
    one process, else None: what the step builders, the Checkpointer and
    the preemption guard span."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def data_group(model=None):
    """The group a step's batch spans: a sharded model's batch axes
    (dcn, dp, fsdp: parallel/placement; its tp peers read the same
    rows), else the job's (job_group)."""
    placement = getattr(model, "placement", None)
    if placement is not None:
        return placement.batch_group
    return job_group()


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


@contextlib.contextmanager
def replicas(group):
    """Run a step's forward and backward over the ranks of `group` (None:
    locally): the batch statistics inside read active()."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, group
    try:
        yield
    finally:
        _ACTIVE = prev


def active():
    """The group of the step running now, or None."""
    return _ACTIVE


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over the ranks of `group`, in place; returns it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _buckets(tensors: Iterable[torch.Tensor]):
    """Runs of tensors of one dtype and device up to BUCKET_BYTES each."""
    run, nbytes, key = [], 0, None
    for t in tensors:
        k = (t.dtype, t.device)
        if run and (k != key or nbytes + t.numel() * t.element_size()
                    > BUCKET_BYTES):
            yield run
            run, nbytes = [], 0
        run.append(t)
        nbytes += t.numel() * t.element_size()
        key = k
    if run:
        yield run


@torch.no_grad()
def mean_gradients_(params: Mapping[str, torch.Tensor], group) -> None:
    """Every parameter's .grad replaced by its mean over the ranks of
    `group`, bucketed: each bucket of gradients is flattened into one
    buffer, summed by one all_reduce, divided by the world size and
    copied back.  A parameter this rank's rows did not reach (an expert
    no local token chose) takes a zero gradient first, so every rank
    sends the same buckets."""
    n = size(group)
    for p in params.values():
        if p.grad is None and p.requires_grad:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params.values() if p.grad is not None]
    for run in _buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in run])
        all_reduce_(flat, group).div_(n)
        offset = 0
        for g in run:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


@torch.no_grad()
def mean_metrics(metrics: Dict[str, torch.Tensor], group
                 ) -> Dict[str, torch.Tensor]:
    """Each scalar metric's mean over the ranks (one all_reduce)."""
    if group is None or not metrics:
        return metrics
    names = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in names])
    all_reduce_(flat, group).div_(size(group))
    return dict(zip(names, flat.unbind()))


def finish_step(state, metrics: Dict[str, torch.Tensor], group):
    """A step's end after backward: the gradients' and the metrics' means
    over `group`, then one optimizer step in place.  Returns (state,
    metrics).  A sharded state (state.layout) completes its gradients
    over its mesh instead (parallel/placement.reduce_gradients_) and
    takes the metrics' means over its batch axes.  The phase span
    `train_step.grad_sync` times the exchange, where there is one."""
    layout = getattr(state, "layout", None)
    if layout is not None:
        with TRACER.phase("train_step.grad_sync"):
            layout.reduce_gradients_(state.params)
            metrics = mean_metrics(metrics, layout.batch_group)
    elif group is not None:
        with TRACER.phase("train_step.grad_sync"):
            mean_gradients_(state.params, group)
            metrics = mean_metrics(metrics, group)
    return state.apply_gradients(), metrics


@torch.no_grad()
def replicate_(module: torch.nn.Module) -> None:
    """Every rank of the job starts from rank 0's parameters and
    buffers: one broadcast a tensor, in place."""
    group = job_group()
    if group is None:
        return
    for t in module.state_dict().values():
        if t.is_contiguous():
            dist.broadcast(t, src=0, group=group)
        else:  # channels_last convolution weights
            buf = t.contiguous()
            dist.broadcast(buf, src=0, group=group)
            t.copy_(buf)


def agree(flag: bool, group) -> bool:
    """True when `flag` is True on any rank (a max over the ranks).  The
    flag crosses NCCL from the current card, gloo from the CPU."""
    if group is None:
        return flag
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.tensor([1.0 if flag else 0.0], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item() > 0)


def barrier(group) -> None:
    if group is not None:
        dist.barrier(group=group)
