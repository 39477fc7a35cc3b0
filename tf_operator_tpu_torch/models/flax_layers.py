"""flax.linen's Conv, Dense, BatchNorm and pooling with flax's padding and
arithmetic, in PyTorch, for the port's vision models (models/resnet.py,
models/mnist.py).

Layout: the models take NHWC input as the JAX package does and run every
convolution on an NCHW view of it in `torch.channels_last` memory (the
same bytes, so no copy): cuDNN's native layout for bf16 convolutions on
the card.  A convolution's weight is stored in torch's [out, in, kh, kw]
order, channels_last; models/vision_bridge transposes flax's
[kh, kw, in, out] kernel.  A Dense kernel keeps flax's [in, out].

  - "SAME" padding is flax's (XLA's): pad_total = max((out - 1)·stride +
    k - in, 0) with out = ceil(in / stride), split pad_total // 2 low and
    the rest high.  A 3x3 stride-2 window over an even size pads (0, 1):
    only the high side, so torch's symmetric `padding=1` would shift
    every window.  Max pooling pads with -inf, as flax's reduce_window.
  - Conv, Dense: input, kernel and bias cast to `dtype`, then the
    product (flax's promote_dtype).
  - BatchNorm: the batch mean and var in f32 by the fast variance
    (E[x²] - E[x]², biased, clamped at 0), y = (x - mean) ·
    (rsqrt(var + eps) · scale) + bias in f32, cast to `dtype`; the
    running stats ra = momentum·ra + (1 - momentum)·batch (f32 buffers
    `mean` and `var`, updated in place in training mode); eval mode
    normalizes by them.  The training forward is one autograd Function
    that saves only its input and the f32 statistics (the backward is
    the closed form of the same function), so a full-size ResNet keeps
    its activations in `dtype`.

`init_(model, seed, device)` draws every layer's parameters and running
stats on the device with flax's default initializers (lecun truncated
normal over the fan-in in·kh·kw or in, zero biases, BatchNorm scale one
or, where the layer asks, zero, running mean 0 and var 1) from one
torch.Generator seeded with `seed`, in module order.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models.bridge import _TRUNC_STD, _trunc_normal_
from tf_operator_tpu_torch.parallel import dp

Padding = Union[str, Sequence[Tuple[int, int]]]


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax's (XLA's) "SAME" padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kernel: Tuple[int, int],
          strides: Tuple[int, int], padding: Padding):
    """((lo_h, hi_h), (lo_w, hi_w)) for an NCHW x."""
    if padding == "SAME":
        return tuple(same_pads(x.shape[2 + i], kernel[i], strides[i])
                     for i in range(2))
    if padding == "VALID":
        return ((0, 0), (0, 0))
    return tuple(tuple(p) for p in padding)


def _pad(x: torch.Tensor, pads, value: float = 0.0):
    """x padded as `pads` says, and the symmetric padding left for the
    op itself: symmetric pads go to the op, uneven ones to F.pad."""
    (lh, hh), (lw, hw) = pads
    if lh == hh and lw == hw:
        return x, (lh, lw)
    return F.pad(x, (lw, hw, lh, hh), value=value), (0, 0)


def max_pool(x: torch.Tensor, window: Tuple[int, int],
             strides: Tuple[int, int], padding: Padding = "VALID"
             ) -> torch.Tensor:
    """flax nn.max_pool over an NCHW x (padding with -inf)."""
    pads = _pads(x, window, strides, padding)
    if pads != ((0, 0), (0, 0)):
        (lh, hh), (lw, hw) = pads
        x = F.pad(x, (lw, hw, lh, hh), value=-math.inf)
    return F.max_pool2d(x, window, strides)


class Conv(nn.Module):
    """flax nn.Conv over an NCHW (channels_last) input."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1),
                 padding: Padding = "SAME", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.strides, self.padding, self.dtype = strides, padding, dtype
        self.kernel_size = tuple(kernel_size)
        self.weight = nn.Parameter(torch.empty(
            features, in_features, *kernel_size).to(
                memory_format=torch.channels_last))
        self.bias = (nn.Parameter(torch.empty(features)) if use_bias
                     else None)

    def fan_in(self) -> int:
        return self.weight.shape[1] * self.kernel_size[0] * self.kernel_size[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x, pad = _pad(x.to(dt), _pads(x, self.kernel_size, self.strides,
                                      self.padding))
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, self.weight.to(dt), b, self.strides, pad)


class Dense(nn.Module):
    """flax nn.Dense: x @ kernel [in, out] + bias, in `dtype`."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = (nn.Parameter(torch.empty(features)) if use_bias
                     else None)

    def fan_in(self) -> int:
        return self.kernel.shape[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = x.to(dt) @ self.kernel.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


def _bcast(t: torch.Tensor) -> torch.Tensor:
    return t[:, None, None]


class _BatchNormTrain(torch.autograd.Function):
    """BatchNorm's training forward on NCHW x: (y, batch mean, batch
    var).  Saves x and the f32 statistics; the backward is the closed
    form dx = scale·inv·(dy - mean(dy) - x̂·mean(dy·x̂)) in f32.

    Under data parallelism (`group` set: parallel/dp) the batch is every
    rank's rows, as JAX's jit over the global batch takes it: the
    forward sums (Σx, Σx², count) over the ranks, and the backward sums
    (Σdy, Σdy·x̂) before it takes their means.  The scale's and bias's
    gradients stay this rank's sums; the step's gradient mean joins
    them."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, dtype, group):
        xf = x.float()
        dims = (0, 2, 3)
        c = x.shape[1]
        sums = torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims),
                          xf.new_full((1,), x.numel() // c)])
        if group is not None:
            dp.all_reduce_(sums, group)
        n = sums[-1]
        mean, sq = sums[:c] / n, sums[c:2 * c] / n
        var = torch.clamp(sq - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        y = ((xf - _bcast(mean)) * _bcast(inv * scale)
             + _bcast(bias)).to(dtype)
        ctx.save_for_backward(x, mean, inv, scale)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, scale = ctx.saved_tensors
        dims = (0, 2, 3)
        n = ctx.n
        dyf = dy.float()
        xhat = (x.float() - _bcast(mean)) * _bcast(inv)
        dbias = dyf.sum(dim=dims)
        dscale = (dyf * xhat).sum(dim=dims)
        sum_dy, sum_dyx = dbias, dscale
        if ctx.group is not None:
            both = dp.all_reduce_(torch.cat([dbias, dscale]), ctx.group)
            sum_dy, sum_dyx = both.chunk(2)
        dx = (dyf - _bcast(sum_dy / n) - xhat * _bcast(sum_dyx / n)) \
            * _bcast(scale * inv)
        return dx.to(x.dtype), dscale, dbias, None, None, None


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over the channels of an NCHW input: batch
    statistics in training mode (and the running stats updated in
    place), the running stats in eval mode."""

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.float32,
                 zero_scale: bool = False) -> None:
        super().__init__()
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.zero_scale = zero_scale  # flax scale_init=zeros
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            inv = torch.rsqrt(self.var + self.epsilon)
            return ((x.float() - _bcast(self.mean)) * _bcast(inv * self.scale)
                    + _bcast(self.bias)).to(self.dtype)
        y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias,
                                             self.epsilon, self.dtype,
                                             dp.active())
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return y


@torch.no_grad()
def init_(model: nn.Module, seed: int,
          device: Union[str, torch.device, None] = None) -> nn.Module:
    """Draw every Conv, Dense and BatchNorm of `model` on `device`
    (default "cuda") with flax's initializers from a generator seeded
    with `seed`; returns the model, now on the device."""
    dev = resolve_device(device)
    model.to_empty(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (Conv, Dense)):
            w = mod.weight if isinstance(mod, Conv) else mod.kernel
            _trunc_normal_(w, 1.0 / math.sqrt(mod.fan_in()) / _TRUNC_STD, gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.scale.fill_(0.0 if mod.zero_scale else 1.0)
            mod.bias.zero_()
            mod.mean.zero_()
            mod.var.fill_(1.0)
    return model


def nhwc_to_nchw(x: torch.Tensor, dtype: Optional[torch.dtype] = None
                 ) -> torch.Tensor:
    """[B, H, W, C] -> the NCHW view of the same bytes (channels_last
    when x is contiguous), cast to `dtype` first."""
    if dtype is not None:
        x = x.to(dtype)
    return x.permute(0, 3, 1, 2)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """An NCHW x flattened in NHWC order, as flax reshapes its NHWC
    arrays, so a Dense kernel carries across unchanged."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
