"""The optimizers of the JAX training entry points, as optax builds them.

Each class keeps optax's chain, order and arithmetic (optax 0.2.6,
`_src/alias.py`, `_src/factorized.py`, `_src/clipping.py`,
`_src/transform.py`) and updates in place (`update_(params, state)`):

  - `Adafactor`: `optax.adafactor(1e-3)` (examples/llama, examples/t5);
  - `AdamW`: `optax.adamw(1e-4, weight_decay=0.01)` (examples/bert);
  - `Adam`: `optax.adam(1e-3)` (examples/mnist);
  - `SGD`: `optax.sgd(lr, momentum=0.9)` (examples/resnet50) and
    `optax.sgd(0.01)` (examples/dist-mnist).

Adafactor's chain:

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

Adam's chain (`scale_by_adam`, then for AdamW `add_decayed_weights`,
then `scale_by_learning_rate`): with t the update count,
mu = (1-b1)·g + b1·mu and nu = (1-b2)·g² + b2·nu; u = mu_hat /
(sqrt(nu_hat) + eps) with mu_hat = mu / (1 - b1^t) and nu_hat =
nu / (1 - b2^t), the corrections in f32; AdamW adds weight_decay·p to
u (every parameter: optax's mask is None); then u·(-lr) is added to p.
torch.optim.AdamW decays p by lr·wd before the Adam step and divides
by the corrections in another order, so it is not used either.
SGD: optax.trace (t = g + momentum·t, the update is t) when momentum
is set, then u·(-lr).  XLA fuses each moment's update into one
multiply-add (fma((1-b1), g, b1·mu), fma((1-b2), g², b2·nu),
fma(momentum, t, g)); `add_(..., alpha=)` rounds once the same way.

Unlike optax, every update runs in place, one parameter at a time: each
parameter's gradient is read, turned into its update, added, and then
dropped (`p.grad = None`), so no whole-tree temporary is ever held — at
llama3_8b's 7.5 B f32 parameters a second copy of the tree would not fit
on the card beside the weights and gradients.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import math

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


def _rms(x: torch.Tensor, name: str = "", layout=None) -> torch.Tensor:
    """sqrt(mean(x²)); under a layout x is a block of the whole leaf
    `name`, and the mean spans the whole."""
    if layout is None:
        return torch.sqrt(torch.mean(x * x))
    return layout.rms(x, layout.spec(name),
                      math.prod(layout.shape(name, x)))


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
                decay: torch.Tensor, layout=None) -> torch.Tensor:
        """Step 1: g scaled by its factored (or full) second-moment
        estimate; updates the statistics in `state` in place.  Under a
        layout (parallel/placement) g is this rank's block of the whole
        gradient: the factoring follows the whole shape, the means over
        sharded dims sum over the ranks holding the pieces, and each
        statistic is held as its own spec places it."""
        g2 = (g * g).add_(EPS)
        whole = tuple(g.shape) if layout is None else layout.shape(name, g)
        sp = () if layout is None else layout.spec(name)
        dims = factored_dims(whole)
        if dims is None:
            sv = () if layout is None else layout.opt_spec("v", name)
            g2 = g2 if layout is None else layout.redistribute(g2, sp, sv)
            v = decay * state["v"][name] + (1.0 - decay) * g2
            state["v"][name] = v
            v = v if layout is None else layout.redistribute(v, sv, sp)
            return g * torch.pow(v, -0.5)
        d1, d0 = dims
        if layout is None:
            r, c = g2.mean(dim=d0), g2.mean(dim=d1)
        else:
            sp = sp + (None,) * (len(whole) - len(sp))
            r = layout.mean(g2, d0, sp, whole[d0])
            c = layout.mean(g2, d1, sp, whole[d1])
            sr = sp[:d0] + sp[d0 + 1:]
            sc = sp[:d1] + sp[d1 + 1:]
            svr = layout.opt_spec("v_row", name)
            svc = layout.opt_spec("v_col", name)
            r, c = layout.redistribute(r, sr, svr), layout.redistribute(
                c, sc, svc)
        del g2
        v_row = decay * state["v_row"][name] + (1.0 - decay) * r
        v_col = decay * state["v_col"][name] + (1.0 - decay) * c
        state["v_row"][name], state["v_col"][name] = v_row, v_col
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        if layout is None:
            row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
        else:
            svr = svr + (None,) * (v_row.dim() - len(svr))
            row_whole = whole[:d0] + whole[d0 + 1:]
            row_col_mean = layout.mean(v_row, reduced_d1, svr,
                                       row_whole[reduced_d1], keepdim=True)
        row_factor = torch.pow(v_row / row_col_mean, -0.5)
        col_factor = torch.pow(v_col, -0.5)
        if layout is not None:
            row_factor = layout.redistribute(row_factor, svr, sr)
            col_factor = layout.redistribute(col_factor, svc, sc)
        u = g * row_factor.unsqueeze(d0)
        return u.mul_(col_factor.unsqueeze(d1))

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor], state: Dict,
                layout=None) -> Dict:
        """One step on every parameter, in place, from p.grad (a missing
        gradient counts as zeros); each gradient is dropped once used.
        The largest parameters go last, when most gradients are freed.
        Under a layout each parameter is this rank's block, and the RMS
        of the update and of the parameter span the whole leaf."""
        t = torch.tensor(state["count"] + 1, dtype=torch.float32)
        decay = 1.0 - t ** (-DECAY_RATE)
        for name, p in sorted(params.items(), key=lambda kv: kv[1].numel()):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
            u = self._scaled(name, g, state, decay.to(p.device), layout)
            del g
            u.div_(torch.clamp(_rms(u, name, layout) / CLIPPING_THRESHOLD,
                               min=1.0))
            u.mul_(self.learning_rate)
            rms = _rms(p, name, layout)
            u.mul_(torch.where(rms <= MIN_PARAM_RMS,
                               torch.full_like(rms, MIN_PARAM_RMS), rms))
            u.mul_(-1.0)
            p.add_(u)
        state["count"] += 1
        return state


def _grad(p: torch.Tensor) -> torch.Tensor:
    """p's gradient (zeros when it has none), dropped from p."""
    g = p.grad if p.grad is not None else torch.zeros_like(p)
    p.grad = None
    return g


def _to_state(layout, t: torch.Tensor, name: str, kind: str
              ) -> torch.Tensor:
    """A block under the parameter's spec as the block of the state leaf
    `kind` (the first parameter of its shape may be placed otherwise)."""
    return layout.redistribute(t, layout.spec(name),
                               layout.opt_spec(kind, name))


def _from_state(layout, t: torch.Tensor, name: str, kind: str
                ) -> torch.Tensor:
    return layout.redistribute(t, layout.opt_spec(kind, name),
                               layout.spec(name))


class AdamW:
    """optax.adamw(learning_rate, b1, b2, eps, weight_decay) with
    eps_root 0 and no mask (Adam: weight_decay 0, as optax.adam's chain
    has no decay step).  `init(params)` returns {"count", "mu", "nu"};
    `update_(params, state)` applies one step in place from each
    parameter's `.grad` and returns the state."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4) -> None:
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict:
        zeros = lambda: {k: torch.zeros_like(
            p, memory_format=torch.contiguous_format)
            for k, p in params.items()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor], state: Dict,
                layout=None) -> Dict:
        """One step in place; under a layout (parallel/placement) every
        tensor is this rank's block, elementwise, with each moment held
        as its spec places it."""
        t = torch.tensor(state["count"] + 1, dtype=torch.float32)
        # 1 - decay**count in f32, as optax's bias correction
        bc1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** t
        bc2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32) ** t
        for name, p in params.items():
            g = _grad(p)
            if layout is not None:
                g = _to_state(layout, g, name, "mu")
            mu, nu = state["mu"][name], state["nu"][name]
            # XLA fuses each moment's b·m + (1-b)·g (g²) into one multiply-add;
            # add_(alpha=) rounds once the same way
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            del g
            dev = p.device
            u = torch.sqrt(nu / bc2.to(dev)).add_(self.eps)
            u = torch.div(mu / bc1.to(dev), u, out=u)
            if layout is not None:
                u = _from_state(layout, u, name, "mu")
            if self.weight_decay:
                u.add_(p * self.weight_decay)
            p.add_(u.mul_(-self.learning_rate))
        state["count"] += 1
        return state


class Adam(AdamW):
    """optax.adam(learning_rate, b1, b2, eps): AdamW's chain without the
    decay step."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8) -> None:
        super().__init__(learning_rate, b1, b2, eps, weight_decay=0.0)


class SGD:
    """optax.sgd(learning_rate, momentum) (no Nesterov).  `init(params)`
    returns {"count", "trace"} ("trace" empty without momentum)."""

    def __init__(self, learning_rate: float,
                 momentum: Optional[float] = None) -> None:
        self.learning_rate = learning_rate
        self.momentum = momentum

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict:
        trace = {} if self.momentum is None else {
            k: torch.zeros_like(p, memory_format=torch.contiguous_format)
            for k, p in params.items()}
        return {"count": 0, "trace": trace}

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor], state: Dict,
                layout=None) -> Dict:
        for name, p in params.items():
            g = _grad(p)
            if self.momentum is None:
                u = g * (-self.learning_rate)
            else:
                tr = state["trace"][name]
                if layout is not None:
                    g = _to_state(layout, g, name, "trace")
                # g + momentum·t as one multiply-add, as XLA fuses it
                torch.add(g, tr, alpha=self.momentum, out=tr)
                u = tr * (-self.learning_rate)
                if layout is not None:
                    u = _from_state(layout, u, name, "trace")
            p.add_(u)
        state["count"] += 1
        return state
