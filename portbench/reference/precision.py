"""Lower precisions for the controls: the reference computed one step
below the precision a configuration states.

  - fp8_mm: every product's operands rounded to float8 e4m3 with one
    scale a tensor (amax / 448), in the forward and in the backward, the
    product then taken in float32 (bfloat16 compute -> fp8);
  - int4_params: int8 weights (payload, scale) requantized to int4 over
    the same contraction axes (absmax / 7 per output channel).
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Fp8MM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fp8_round(a) @ fp8_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = fp8_round(g)
        return g8 @ fp8_round(b).t(), fp8_round(a).t() @ g8


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        if a.dim() != 2 or b.dim() != 2:
            raise ValueError("the fp8 product takes gradients of 2-D "
                             "operands only")
        return _Fp8MM.apply(a, b)
    return fp8_round(a) @ fp8_round(b)


def int4_pair(pair):
    """(payload, scale) of int8 as the int4 (payload, scale) nearest to
    it: absmax / 7 over the axes the scale is reduced over."""
    q, scale = pair
    axes = tuple(i for i in range(q.dim())
                 if scale.shape[i] == 1 and q.shape[i] > 1)
    qf = q.to(torch.float32)
    amax = qf.abs().amax(dim=axes, keepdim=True).clamp(min=1.0)
    q4 = torch.clamp(torch.round(qf * (7.0 / amax)), -7, 7)
    return (q4, scale * (amax / 7.0))


def int4_params(p: dict) -> dict:
    return {k: int4_pair(v) if isinstance(v, tuple) else v
            for k, v in p.items()}
