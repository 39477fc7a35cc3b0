"""Training runtime on one device: the train state and the train step.

The port of what tf_operator_tpu/runtime/train.py does on one device:
`TrainState` (step, params, optimizer state, batch stats),
`cross_entropy_loss` and `make_train_step` with gradient accumulation.
PyTorch runs eagerly, so there is no jit, no donation and no mesh; the
step updates the state IN PLACE (the parameters are the model's own
tensors and the optimizer writes them) and returns it, where the JAX step
returns a new state.  Meshes and shardings are ROADMAP Queue 1 item 11;
`Checkpointer` waits for the next slice (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict

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
