"""Adafactor as optax.adafactor builds it, for the port's training step.

The JAX training entry point (examples/llama/train_llama.py) trains with
`optax.adafactor(1e-3)` and its defaults.  This is that chain, in optax's
order and arithmetic (optax 0.2.6, `_src/alias.py`, `_src/factorized.py`,
`_src/clipping.py`, `_src/transform.py`):

  1. scale_by_factored_rms: with t the update count, β₂ = 1 - (t+1)^-0.8
     and g² + 1e-30, an f32 parameter whose two largest dims (the last two
     of np.argsort(shape), ties as numpy breaks them) are >= 128 keeps row
     and column means of g² and scales g by
     (v_row / mean(v_row))^-½ · v_col^-½; any other parameter keeps the
     full v and scales g by v^-½;
  2. clip_by_block_rms(1.0): u / max(1, rms(u));
  3. scale by the learning rate;
  4. scale_by_param_block_rms: u · max(rms(param), 1e-3);
  5. negate, and add to the parameter.

`torch.optim.Adafactor` is a different algorithm (relative step sizes,
another clipping) and is not used.

Unlike optax, the update runs in place, one parameter at a time: each
parameter's gradient is read, turned into its update, added, and then
dropped (`p.grad = None`), so no whole-tree temporary is ever held — at
llama3_8b's 7.5 B f32 parameters a second copy of the tree would not fit
on the card beside the weights and gradients.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# optax.adafactor's defaults, the only values the JAX training uses
MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
CLIPPING_THRESHOLD = 1.0
EPS = 1e-30
MIN_PARAM_RMS = 1e-3


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """(d1, d0): the second-largest and the largest dim, by np.argsort as
    optax picks them; None when the parameter is 1-D or the second-largest
    dim is below MIN_DIM_SIZE_TO_FACTOR."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


class Adafactor:
    """optax.adafactor(learning_rate) with its defaults (no momentum, no
    weight decay).  `init(params)` returns the state for a dict of
    parameters; `update_(params, state)` applies one step in place from
    each parameter's `.grad` and returns the new state."""

    def __init__(self, learning_rate: float) -> None:
        self.learning_rate = learning_rate

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict:
        """{"count": 0, "v_row"/"v_col"/"v": {name: f32 statistics}}, as
        optax's FactoredState keeps them (factored parameters hold v_row
        and v_col, the others v)."""
        v_row, v_col, v = {}, {}, {}
        for name, p in params.items():
            dims = factored_dims(p.shape)
            if dims is None:
                v[name] = torch.zeros_like(p, memory_format=torch.contiguous_format)
                continue
            d1, d0 = dims
            shape = list(p.shape)
            v_row[name] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
            v_col[name] = p.new_zeros(shape[:d1] + shape[d1 + 1:])
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    def _scaled(self, name: str, g: torch.Tensor, state: Dict,
                decay: torch.Tensor) -> torch.Tensor:
        """Step 1: g scaled by its factored (or full) second-moment
        estimate; updates the statistics in `state` in place."""
        g2 = (g * g).add_(EPS)
        dims = factored_dims(g.shape)
        if dims is None:
            v = decay * state["v"][name] + (1.0 - decay) * g2
            state["v"][name] = v
            return g * torch.pow(v, -0.5)
        d1, d0 = dims
        v_row = decay * state["v_row"][name] + (1.0 - decay) * g2.mean(dim=d0)
        v_col = decay * state["v_col"][name] + (1.0 - decay) * g2.mean(dim=d1)
        del g2
        state["v_row"][name], state["v_col"][name] = v_row, v_col
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
        row_factor = torch.pow(v_row / row_col_mean, -0.5)
        col_factor = torch.pow(v_col, -0.5)
        u = g * row_factor.unsqueeze(d0)
        return u.mul_(col_factor.unsqueeze(d1))

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor], state: Dict) -> Dict:
        """One step on every parameter, in place, from p.grad (a missing
        gradient counts as zeros); each gradient is dropped once used.
        The largest parameters go last, when most gradients are freed."""
        t = torch.tensor(state["count"] + 1, dtype=torch.float32)
        decay = 1.0 - t ** (-DECAY_RATE)
        for name, p in sorted(params.items(), key=lambda kv: kv[1].numel()):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            u = self._scaled(name, g, state, decay.to(p.device))
            del g
            u.div_(torch.clamp(_rms(u) / CLIPPING_THRESHOLD, min=1.0))
            u.mul_(self.learning_rate)
            rms = _rms(p)
            u.mul_(torch.where(rms <= MIN_PARAM_RMS,
                               torch.full_like(rms, MIN_PARAM_RMS), rms))
            u.mul_(-1.0)
            p.add_(u)
        state["count"] += 1
        return state
