"""Adafactor as optax.adafactor(learning_rate) defines it, in plain
PyTorch (Shazeer and Stern, arXiv:1804.04235, with optax's defaults: no
momentum, no weight decay).

For step t = 1, 2, ...: decay = 1 - t^-0.8 and g2 = g^2 + 1e-30.  A
parameter whose two largest dims (the last two of a stable argsort of
its shape) are both at least 128 keeps v_row = mean of g2 over the
largest dim and v_col = mean over the second largest, each an
exponential average at that decay, and scales g by
(v_row / mean(v_row))^-1/2 * v_col^-1/2; any other parameter keeps the
full average v and scales g by v^-1/2.  The update is then divided by
max(1, rms(u)), multiplied by the learning rate and by
max(rms(param), 1e-3), and subtracted from the parameter.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def factored(shape) -> Optional[Tuple[int, int]]:
    """(second largest dim, largest dim), or None when not factored."""
    if len(shape) < 2:
        return None
    order = np.argsort(np.asarray(shape), kind="stable")
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    def __init__(self, learning_rate: float):
        self.lr = learning_rate
        self.t = 0
        self.state: Dict[str, dict] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor]) -> None:
        """One update of every parameter from its .grad, in place; each
        gradient is dropped once used."""
        self.t += 1
        decay = 1.0 - self.t ** -0.8
        for name, p in params.items():
            g = p.grad
            p.grad = None
            g2 = g * g + 1e-30
            st = self.state.setdefault(name, {})
            dims = factored(tuple(p.shape))
            if dims is None:
                v = decay * st.get("v", torch.zeros_like(g2)) + (1 - decay) * g2
                st["v"] = v
                u = g / torch.sqrt(v)
            else:
                d1, d0 = dims
                r = g2.mean(dim=d0)
                c = g2.mean(dim=d1)
                vr = decay * st.get("v_row", torch.zeros_like(r)) + (1 - decay) * r
                vc = decay * st.get("v_col", torch.zeros_like(c)) + (1 - decay) * c
                st["v_row"], st["v_col"] = vr, vc
                rd1 = d1 - 1 if d1 > d0 else d1
                row = vr / vr.mean(dim=rd1, keepdim=True)
                u = g / torch.sqrt(row.unsqueeze(d0)) / torch.sqrt(vc.unsqueeze(d1))
            del g, g2
            u = u / torch.clamp(torch.sqrt((u * u).mean()), min=1.0)
            u = u * self.lr * torch.clamp(torch.sqrt((p * p).mean()), min=1e-3)
            p.sub_(u)
