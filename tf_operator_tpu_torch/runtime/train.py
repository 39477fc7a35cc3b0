"""Training runtime on one device: the train state and the train step.

The port of what tf_operator_tpu/runtime/train.py does on one device:
`TrainState` (step, params, optimizer state, batch stats),
`cross_entropy_loss` and `make_train_step` with gradient accumulation.
PyTorch runs eagerly, so there is no jit, no donation and no mesh; the
step updates the state IN PLACE (the parameters are the model's own
tensors and the optimizer writes them) and returns it, where the JAX step
returns a new state.  Meshes and shardings are ROADMAP Queue 1 item 11;
`create_train_state` (flax-style models with batch statistics) is item 10.

`Checkpointer` is the port of the JAX package's orbax checkpoint manager,
on torch.save / torch.load: one directory per step under the checkpoint
directory, written under a temporary name and renamed into place, so a
cut save leaves the newest complete step as the latest.
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


@dataclass
class TrainState:
    """step + params (the model's parameters by name, the f32 masters the
    optimizer updates) + opt state + batch stats (an empty slot: no model
    of the port keeps running statistics)."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any
    tx: Any
    batch_stats: Dict = field(default_factory=dict)

    @classmethod
    def create(cls, model: nn.Module, tx) -> "TrainState":
        params = dict(model.named_parameters())
        return cls(step=0, params=params, opt_state=tx.init(params), tx=tx)

    def apply_gradients(self) -> "TrainState":
        """One optimizer step from the parameters' .grad, in place; the
        gradients are dropped as they are used."""
        self.opt_state = self.tx.update_(self.params, self.opt_state)
        self.step += 1
        return self


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Integer-label cross-entropy, averaged (no one-hot temporary)."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           labels.reshape(-1).long())


def make_train_step(model: nn.Module,
                    loss_fn: Callable = cross_entropy_loss,
                    accum_steps: int = 1) -> Callable:
    """(state, inputs, labels) -> (state, {"loss", "accuracy"}).

    `accum_steps > 1` splits the batch into that many equal micro-batches,
    runs forward and backward on each (their gradients sum in .grad), and
    applies ONE optimizer update with the mean gradient: activation memory
    scales with the micro-batch, and for models without batch statistics
    the update is the full-batch one."""

    def forward_backward(x, y):
        logits = model(x)
        loss = loss_fn(logits, y)
        loss.backward()
        accuracy = (logits.argmax(dim=-1) == y).float().mean()
        return loss.detach(), accuracy

    def step(state: TrainState, inputs: torch.Tensor, labels: torch.Tensor):
        if accum_steps == 1:
            loss, accuracy = forward_backward(inputs, labels)
            return state.apply_gradients(), {"loss": loss,
                                             "accuracy": accuracy}
        b = inputs.shape[0]
        if b % accum_steps != 0:
            raise ValueError(
                f"batch size {b} not divisible by accum_steps {accum_steps}")
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
        return state.apply_gradients(), {"loss": loss_sum / accum_steps,
                                         "accuracy": acc_sum / accum_steps}

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
    wait_until_finished() joins it and re-raises any error it met."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False) -> None:
        self.directory = os.fspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
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
        payload = (_to_host(dict(state.params)),
                   _to_host({"step": int(state.step),
                             "opt_state": state.opt_state,
                             "batch_stats": dict(state.batch_stats)}))
        self._pending = step
        if wait or not self.async_save:
            try:
                self._write(step, *payload)
            finally:
                self._pending = None
            return True
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
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step}")
        shutil.rmtree(tmp, ignore_errors=True)  # an earlier cut save
        os.makedirs(tmp)
        for obj, name in ((params, PARAMS_FILE), (rest, STATE_FILE)):
            torch.save(obj, os.path.join(tmp, name))
            _fsync(os.path.join(tmp, name))
        _fsync(tmp)
        os.replace(tmp, self._step_dir(step))
        _fsync(self.directory)  # the rename, before older steps go
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Block until the save in flight is durable; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._pending = None
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
        optimizer state, the step and the batch statistics are replaced
        (the optimizer state on the parameters' device)."""
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
        device = next(iter(state.params.values())).device
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(saved[k])
        state.step = rest["step"]
        state.opt_state = _to_device(rest["opt_state"], device)
        state.batch_stats = _to_device(rest["batch_stats"], device)
        return state
