"""Training runtime: the train state and the train step.

The port of what tf_operator_tpu/runtime/train.py does:
`TrainState` (step, params, optimizer state, batch stats),
`create_train_state`, `cross_entropy_loss`, `make_train_step` with
gradient accumulation and `make_eval_step`.  PyTorch runs eagerly, so
there is no jit and no donation; the step updates the state IN PLACE
(the parameters are the model's own tensors and the optimizer writes
them; the batch statistics are the model's BatchNorm buffers, which its
training forward updates) and returns it, where the JAX step returns a
new state.  The JAX step's dp mesh axis is a process group here
(parallel/dp): params replicated, each process a shard of the batch, the
gradients averaged over the processes before the update.  Under a
dp x fsdp x ep x tp mesh (parallel/mesh, parallel/placement) the state
is this rank's blocks of JAX's layout (the experts' over ep) and the
step completes the gradients over the mesh.

`Checkpointer` is the port of the JAX package's orbax checkpoint manager,
on torch.save / torch.load: one directory per step under the checkpoint
directory, written under a temporary name and renamed into place, so a
cut save leaves the newest complete step as the latest.  In a job of
several processes the params are replicated: rank 0 writes, every rank
restores from the shared directory.
"""
from __future__ import annotations

import os
import shutil
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.engine.tracing import get_tracer
from tf_operator_tpu_torch.models.flax_layers import init_
from tf_operator_tpu_torch.parallel import dp

# the phase spans of a step (engine/tracing: on while torch.profiler
# captures): train_step > forward, backward, grad_sync, optimizer
TRACER = get_tracer()


@dataclass
class TrainState:
    """step + params (the model's parameters by name, the f32 masters the
    optimizer updates) + opt state + batch stats (the model's buffers by
    name: the running mean and var of each BatchNorm layer
    (models/flax_layers), which a forward in training mode updates in
    place; empty for models without them)."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any
    tx: Any
    batch_stats: Dict = field(default_factory=dict)
    # a sharded model's parallel/placement.Placement: params and
    # opt_state are then this rank's blocks of the whole state
    layout: Any = None

    @classmethod
    def create(cls, model: nn.Module, tx,
               params: Optional[Mapping[str, torch.Tensor]] = None
               ) -> "TrainState":
        """The state of `model` under `tx`: the optimizer holds `params`
        (default every parameter of the model; models/lora passes its
        adapters alone, so the frozen base keeps no optimizer state).
        For a sharded model (parallel/placement.place) the parameters
        are this rank's shards by their plain names, and the optimizer
        state is this rank's block of the state JAX's state_sharding
        places."""
        layout = getattr(model, "placement", None)
        if params is None:
            params = (layout.params(model) if layout is not None
                      else dict(model.named_parameters()))
        params = dict(params.items())
        opt_state = (tx.init(params) if layout is None
                     else layout.init_opt_state(tx, params))
        return cls(step=0, params=params, opt_state=opt_state, tx=tx,
                   batch_stats=dict(model.named_buffers()), layout=layout)

    def apply_gradients(self) -> "TrainState":
        """One optimizer step from the parameters' .grad, in place; the
        gradients are dropped as they are used.  The phase span
        `train_step.optimizer` times it."""
        with TRACER.phase("train_step.optimizer"):
            if self.layout is None:
                self.opt_state = self.tx.update_(self.params, self.opt_state)
            else:
                self.opt_state = self.tx.update_(self.params, self.opt_state,
                                                 self.layout)
        self.step += 1
        return self


def create_train_state(model: nn.Module, sample_input: torch.Tensor, tx,
                       seed: int = 0, device=None) -> TrainState:
    """The train state of a flax-style model (models/resnet.py,
    models/mnist.py): its parameters and running stats drawn on `device`
    (default "cuda") with flax's initializers from `seed`
    (models/flax_layers.init_), checked by one eval-mode forward of the
    first row of `sample_input` (where flax's init runs the model on
    it), and the optimizer state of `tx`.  The model is left on the
    device in training mode."""
    dev = resolve_device(device)
    init_(model, seed, dev)
    model.eval()
    with torch.no_grad():
        model(sample_input[:1].to(dev))
    model.train()
    return TrainState.create(model, tx)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Integer-label cross-entropy, averaged (no one-hot temporary)."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           labels.reshape(-1).long())


def fsdp_param_sharding(params: Mapping[str, Any], mesh,
                        min_size: int = 2**14) -> Dict[str, tuple]:
    """{name: spec}: each large parameter sharded along its largest
    fsdp-divisible dim, the small ones replicated (the JAX package's
    generic fsdp placement; parallel/placement applies it)."""
    from tf_operator_tpu_torch.parallel.mesh import pick_fsdp_dim

    fsdp = mesh.shape.get("fsdp", 1)
    out = {}
    for name, x in params.items():
        shape = tuple(getattr(x, "shape", x))
        d = pick_fsdp_dim(shape, fsdp, min_size)
        spec = [None] * len(shape)
        if d is not None:
            spec[d] = "fsdp"
        out[name] = tuple(spec) if d is not None else ()
    return out


def loss_step(state: TrainState, batch: torch.Tensor,
              loss_fn: Callable[[], torch.Tensor], group):
    """One step of train_llama's, train_t5's and train_bert's step
    functions: loss_fn()'s forward and backward with the batch split over
    `group`, then parallel/dp.finish_step.  Returns (state, {"loss"}).
    The phase spans: train_step > forward, backward, (grad_sync,)
    optimizer."""
    with TRACER.train_step(state.step, batch):
        with dp.replicas(group):
            with TRACER.phase("train_step.forward"):
                loss = loss_fn()
            with TRACER.phase("train_step.backward"):
                loss.backward()
        return dp.finish_step(state, {"loss": loss.detach()}, group)


def _check_batch_stats(model: nn.Module, has_batch_stats: bool) -> None:
    if not has_batch_stats and next(model.buffers(), None) is not None:
        raise ValueError("has_batch_stats=False, but the model keeps "
                         "running statistics (buffers)")


def make_train_step(model: nn.Module,
                    loss_fn: Callable = cross_entropy_loss,
                    has_batch_stats: bool = True,
                    accum_steps: int = 1,
                    data_parallel: bool = True,
                    rules=None, mesh=None,
                    state_shardings=None) -> Callable:
    """(state, inputs, labels) -> (state, {"loss", "accuracy"}), the model
    in training mode: a model with batch statistics normalizes by each
    batch's and updates its running stats in place (state.batch_stats
    holds them).  has_batch_stats=False refuses a model that keeps
    running stats (buffers), as flax's apply does without them.

    In a job of several processes (parallel/dp) with `data_parallel`,
    `inputs` are this rank's rows of the global batch; the batch
    statistics span every rank's, and the gradients and metrics are
    averaged over the ranks before the update, as the JAX step under a
    dp mesh does.  data_parallel=False trains each process's replica
    alone, as the JAX step without a mesh does (train_mnist).

    `accum_steps > 1` splits the batch into that many equal micro-batches,
    runs forward and backward on each (their gradients sum in .grad), and
    applies ONE optimizer update with the mean gradient: activation memory
    scales with the micro-batch, and for models without batch statistics
    the update is the full-batch one.  The running stats are updated
    micro-batch after micro-batch, as the JAX step's scan chains them.

    A sharded model (parallel/placement.place over `mesh`) splits the
    batch over `rules`' "batch" axes (default DEFAULT_RULES: dcn, dp,
    fsdp): `inputs` are this data member's rows, which its tp peers read
    too.  `state_shardings` (parallel/tp.state_sharding; requires
    `mesh`) pins the state's placement: every step checks that each
    parameter is still the block its spec gives this rank."""
    _check_batch_stats(model, has_batch_stats)
    if state_shardings is not None and mesh is None:
        raise ValueError("state_shardings requires mesh")
    group = dp.data_group(model) if data_parallel else None
    placement = getattr(model, "placement", None)
    if placement is not None and rules is not None and mesh is not None:
        group = mesh.group(rules.mesh_axes("batch"))
    pinned = None
    if state_shardings is not None:
        from tf_operator_tpu_torch.parallel.mesh import local_shape

        shapes = placement.shapes if placement is not None else {}
        pinned = {k: local_shape(shapes.get(k, ()), spec, mesh)
                  for k, spec in state_shardings.params.items()}

    def forward_backward(x, y):
        with dp.replicas(group):
            with TRACER.phase("train_step.forward"):
                logits = model(x)
                loss = loss_fn(logits, y)
            with TRACER.phase("train_step.backward"):
                loss.backward()
        accuracy = (logits.argmax(dim=-1) == y).float().mean()
        return loss.detach(), accuracy

    def finish(state, metrics):
        out = dp.finish_step(state, metrics, group)
        if pinned is not None:
            moved = [k for k, shape in pinned.items()
                     if tuple(state.params[k].shape) != shape]
            if moved:
                raise RuntimeError(f"the step moved {moved[:5]} off their "
                                   f"pinned shardings")
        return out

    def step(state: TrainState, inputs: torch.Tensor, labels: torch.Tensor):
        with TRACER.train_step(state.step, labels):
            model.train()
            if accum_steps == 1:
                loss, accuracy = forward_backward(inputs, labels)
                return finish(state, {"loss": loss, "accuracy": accuracy})
            b = inputs.shape[0]
            if b % accum_steps != 0:
                raise ValueError(f"batch size {b} not divisible by "
                                 f"accum_steps {accum_steps}")
            micro = b // accum_steps
            loss_sum = torch.zeros((), device=inputs.device)
            acc_sum = torch.zeros((), device=inputs.device)
            for i in range(accum_steps):
                sl = slice(i * micro, (i + 1) * micro)
                loss, accuracy = forward_backward(inputs[sl], labels[sl])
                loss_sum = loss_sum + loss
                acc_sum = acc_sum + accuracy
            with torch.no_grad():
                for p in state.params.values():
                    if p.grad is not None:
                        p.grad.div_(accum_steps)
            return finish(state, {"loss": loss_sum / accum_steps,
                                  "accuracy": acc_sum / accum_steps})

    return step


def make_eval_step(model: nn.Module, has_batch_stats: bool = True
                   ) -> Callable:
    """(state, inputs, labels) -> {"loss", "accuracy"} without gradients,
    the model in eval mode (normalized by its running stats); the model's
    mode is put back after."""
    _check_batch_stats(model, has_batch_stats)

    @torch.no_grad()
    def step(state: TrainState, inputs: torch.Tensor, labels: torch.Tensor):
        was = model.training
        model.eval()
        try:
            logits = model(inputs)
        finally:
            model.train(was)
        return {"loss": cross_entropy_loss(logits, labels),
                "accuracy": (logits.argmax(dim=-1) == labels).float().mean()}

    return step


# ---------------------------------------------------------------------------
# Checkpointing: resume = pod recreation with stable identity + the
# framework's own restore; this is the framework side.
# ---------------------------------------------------------------------------
PARAMS_FILE = "params.pt"   # {name: tensor}: what a serving process reads
STATE_FILE = "state.pt"     # {"step", "opt_state", "batch_stats"}
_TMP_PREFIX = ".tmp-"


def _to_host(tree):
    """A host copy of every tensor in a nested dict (ints pass through):
    the snapshot a save writes, taken before the caller's next in-place
    step can overwrite what it reads."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _fsync(path: str) -> None:
    """Flush a file's or a directory's entry to the disk: a written step
    survives the node, not only the process."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_step(directory: str, step: int, params, rest) -> None:
    """Write one step's files atomically: into `<directory>/.tmp-<step>`
    (an earlier cut write there removed), each file and the directory
    fsynced, then renamed to `<directory>/<step>` and the rename
    fsynced.  A step already there must be removed first."""
    tmp = os.path.join(directory, f"{_TMP_PREFIX}{step}")
    shutil.rmtree(tmp, ignore_errors=True)  # an earlier cut save
    os.makedirs(tmp)
    for obj, name in ((params, PARAMS_FILE), (rest, STATE_FILE)):
        torch.save(obj, os.path.join(tmp, name))
        _fsync(os.path.join(tmp, name))
    _fsync(tmp)
    os.replace(tmp, os.path.join(directory, str(step)))
    _fsync(directory)  # the rename, before older steps go


def _whole_to_host(tree, specs, layout, keep: bool):
    """The whole of every leaf of a sharded tree (parallel/placement:
    every rank gathers one leaf at a time), copied to the host where
    `keep` (the writing rank) and dropped elsewhere."""
    if isinstance(tree, torch.Tensor):
        whole = layout.full(tree.detach(), specs)
        return whole.to("cpu", copy=True) if keep else None
    if isinstance(tree, dict):
        return {k: _whole_to_host(v, specs[k], layout, keep)
                for k, v in tree.items()}
    return tree


def _shards(tree, specs, layout, device: torch.device):
    """This rank's block of every whole leaf of a saved tree."""
    if isinstance(tree, torch.Tensor):
        return layout.shard(tree, specs).to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _shards(v, specs[k], layout, device)
                for k, v in tree.items()}
    return tree


def _to_device(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree


class Checkpointer:
    """Checkpoint manager with orbax's step semantics, as the JAX package's
    `Checkpointer` keeps them:

      - latest_step() is None on an empty directory;
      - max_to_keep keeps the newest N steps (older ones are deleted once
        a newer save is durable);
      - a save of a step at or below the newest is skipped (orbax's
        should_save) and returns False;
      - restore() with no checkpoint returns the state unchanged;
      - restore_params() with none raises ValueError.

    Layout: `<directory>/<step>/params.pt` holds the parameters by name,
    `state.pt` the step, the optimizer state and the batch statistics, so
    `restore_params` reads only the parameters, memory-mapped (a serving
    process has no optimizer).  A step is written into
    `<directory>/.tmp-<step>`, its files and the directory fsynced, and
    renamed into place by os.replace, the rename fsynced before any older
    step is deleted: a save cut by SIGTERM, OOM, a full disk or the loss
    of the node leaves no step directory behind, and latest_step() stays
    at the last complete one.

    `async_save=True` overlaps the write with training, as orbax's async
    mode does.  The port's step updates the parameters IN PLACE, so save()
    first copies every tensor to the host, and only the write runs on a
    background thread; a second save waits for the one in flight, and
    wait_until_finished() joins it and re-raises any error it met.

    A sharded state (TrainState.layout: parallel/placement) is saved in
    the same files as a one-process job's: every rank gathers each leaf
    whole, one at a time, and rank 0 keeps and writes it; restore() reads
    the whole leaves and keeps this rank's block, so a checkpoint moves
    between a one-process job and any mesh, either way.

    In a job of several processes (parallel/dp.job_group; the directory
    shared): every rank calls save() and restore() at the same steps;
    rank 0 alone copies and writes, and every rank passes a barrier once
    the step's rename is durable (at the save, or at wait_until_finished
    for an async one), so no rank goes on to read a step that is not yet
    on disk."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False) -> None:
        self.directory = os.fspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.group = dp.job_group()
        self.primary = dp.rank(self.group) == 0
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[int] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- steps
    def all_steps(self) -> List[int]:
        """The complete steps on disk, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        """The newest step saved by this manager or found on disk (a save
        still in flight counts, as orbax counts it)."""
        steps = self.all_steps()
        if self._pending is not None:
            steps.append(self._pending)
        return max(steps) if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    # -------------------------------------------------------------- save
    def save(self, step: int, state: "TrainState", wait: bool = False
             ) -> bool:
        """Save `state` as `step`; returns False (and writes nothing) when
        `step` is not past the newest step.  Returns once the state is
        copied to the host; the write is durable on return unless
        async_save and not wait."""
        self.wait_until_finished()
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        lay = state.layout
        if lay is not None:
            # every rank gathers each leaf; rank 0 keeps the whole
            params = {k: _whole_to_host(p, lay.spec(k), lay, self.primary)
                      for k, p in state.params.items()}
            opt = _whole_to_host(state.opt_state, lay.opt_specs, lay,
                                 self.primary)
            payload = (params, {"step": int(state.step), "opt_state": opt,
                                "batch_stats": _to_host(
                                    dict(state.batch_stats))}
                       ) if self.primary else None
        else:
            payload = (_to_host(dict(state.params)),
                       _to_host({"step": int(state.step),
                                 "opt_state": state.opt_state,
                                 "batch_stats": dict(state.batch_stats)})
                       ) if self.primary else None
        self._pending = step
        if wait or not self.async_save:
            try:
                if self.primary:
                    self._write(step, *payload)
            finally:
                self._pending = None
            dp.barrier(self.group)
            return True
        if self.primary:
            self._thread = threading.Thread(
                target=self._write_async, args=(step,) + payload,
                name=f"checkpoint-save-{step}", daemon=True)
            self._thread.start()
        return True

    def _write_async(self, step: int, params, rest) -> None:
        try:
            self._write(step, params, rest)
        except BaseException as e:  # re-raised by wait_until_finished
            self._error = e

    def _write(self, step: int, params, rest) -> None:
        write_step(self.directory, step, params, rest)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Block until the save in flight is durable; re-raise its error."""
        in_flight = self._pending is not None
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._pending = None
        if in_flight:
            dp.barrier(self.group)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ----------------------------------------------------------- restore
    def _resolve(self, step: Optional[int]) -> Optional[int]:
        self.wait_until_finished()
        return step if step is not None else self.latest_step()

    def restore_params(self, params: Optional[Mapping[str, torch.Tensor]]
                       = None, step: Optional[int] = None,
                       device="cpu") -> Dict[str, torch.Tensor]:
        """ONLY the parameters of `step` (default the newest), by name,
        on `device` — the inference path (generate_llama, serve_llama).
        `params`, when given, is a template: only its names are read, and
        each tensor is cast to the template's dtype (a serving model's
        storage dtypes: the trainer saves f32 masters).  Without it every
        saved tensor comes back as saved."""
        step = self._resolve(step)
        if step is None:
            raise ValueError("no checkpoint to restore params from")
        saved = torch.load(os.path.join(self._step_dir(step), PARAMS_FILE),
                           mmap=True, weights_only=True)
        if params is None:
            return {k: v.to(device) for k, v in saved.items()}
        missing = sorted(set(params) - set(saved))
        if missing:
            raise KeyError(f"step {step} holds no {missing[:5]}")
        return {k: saved[k].to(device=device, dtype=t.dtype)
                for k, t in params.items()}

    def restore(self, state: "TrainState", step: Optional[int] = None
                ) -> "TrainState":
        """`state` restored from `step` (default the newest), or `state`
        unchanged when there is no checkpoint.  The parameters are the
        model's own tensors, so they are overwritten in place; the
        optimizer state and the step are replaced
        (the optimizer state on the parameters' device).  The batch
        statistics are the model's buffers too: overwritten in place."""
        step = self._resolve(step)
        if step is None:
            return state
        path = self._step_dir(step)
        saved = torch.load(os.path.join(path, PARAMS_FILE), mmap=True,
                           weights_only=True)
        if set(saved) != set(state.params):
            raise ValueError(
                f"step {step}'s parameters do not match the state: "
                f"missing {sorted(set(state.params) - set(saved))[:5]}, "
                f"unexpected {sorted(set(saved) - set(state.params))[:5]}")
        rest = torch.load(os.path.join(path, STATE_FILE), weights_only=True)
        stats = rest["batch_stats"]
        if set(stats) != set(state.batch_stats):
            raise ValueError(
                f"step {step}'s batch stats do not match the state: saved "
                f"{sorted(stats)[:5]}, state {sorted(state.batch_stats)[:5]}")
        device = next(iter(state.params.values())).device
        lay = state.layout
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(saved[k] if lay is None
                        else lay.shard(saved[k], lay.spec(k)))
            for k, b in state.batch_stats.items():
                b.copy_(stats[k])
        state.step = rest["step"]
        state.opt_state = (
            _to_device(rest["opt_state"], device) if lay is None
            else _shards(rest["opt_state"], lay.opt_specs, lay, device))
        return state
