"""ResNet family in PyTorch — the benchmark ladder's config #3 workhorse
(ResNet-50 images/s is BASELINE.md's headline metric).

The port of tf_operator_tpu/models/resnet.py: `BottleneckBlock`,
`ResNet`, `ResNet18/50/101/152` and `flops_per_image`, over the flax-style
layers of models/flax_layers.py: NHWC input (cast to `dtype`), every
convolution on cuDNN in channels_last memory with flax's "SAME" padding
(the 3x3 stride-2 conv2 and the stride-2 max pool pad only the high side
of an even size), BatchNorm with flax's arithmetic (momentum 0.9, eps
1e-5, the running stats updated in place in training mode, used in eval
mode), bn3's scale starting at zero, and an f32 Dense head over the
spatial mean.  The JAX package leaves these convolutions, products and
reductions to XLA (no Pallas kernel), so they run here as cuDNN/cuBLAS
calls.

The stem's input channels (3) and each block's are fixed when the model
is built, where flax infers them from the first input.  Submodule names
follow flax's (`conv_init`, `bn_init`, `stage{i}_block{j}`, `head`).
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
from torch import nn

from tf_operator_tpu_torch.models.flax_layers import (
    BatchNorm, Conv, Dense, max_pool, nhwc_to_nchw)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with a projection shortcut when the
    shape changes."""

    def __init__(self, in_features: int, features: int,
                 strides: Tuple[int, int] = (1, 1),
                 dtype: torch.dtype = torch.bfloat16,
                 momentum: float = 0.9, epsilon: float = 1e-5) -> None:
        super().__init__()
        conv = functools.partial(Conv, use_bias=False, dtype=dtype)
        norm = functools.partial(BatchNorm, momentum=momentum,
                                 epsilon=epsilon, dtype=dtype)
        self.conv1 = conv(in_features, features, (1, 1))
        self.bn1 = norm(features)
        self.conv2 = conv(features, features, (3, 3), strides)
        self.bn2 = norm(features)
        self.conv3 = conv(features, features * 4, (1, 1))
        # zero-init final BN scale: residual branch starts as identity
        self.bn3 = norm(features * 4, zero_scale=True)
        if in_features != features * 4 or tuple(strides) != (1, 1):
            self.conv_proj = conv(in_features, features * 4, (1, 1), strides)
            self.bn_proj = norm(features * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if hasattr(self, "conv_proj"):
            residual = self.bn_proj(self.conv_proj(residual))
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """forward(x [B, H, W, C]) -> f32 logits [B, num_classes]; batch
    statistics in training mode (model.train()), the running averages in
    eval mode."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width: int = 64, dtype: torch.dtype = torch.bfloat16,
                 in_channels: int = 3) -> None:
        super().__init__()
        self.dtype = dtype
        norm = functools.partial(BatchNorm, momentum=0.9, epsilon=1e-5,
                                 dtype=dtype)
        self.conv_init = Conv(in_channels, width, (7, 7), (2, 2),
                              padding=[(3, 3), (3, 3)], use_bias=False,
                              dtype=dtype)
        self.bn_init = norm(width)
        self.block_names = []
        feats = width
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, BottleneckBlock(
                    feats, width * 2 ** i, strides, dtype))
                self.block_names.append(name)
                feats = width * 2 ** i * 4
        self.head = Dense(feats, num_classes, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(x, self.dtype)
        x = torch.relu(self.bn_init(self.conv_init(x)))
        x = max_pool(x, (3, 3), (2, 2), "SAME")
        for name in self.block_names:
            x = getattr(self, name)(x)
        # jnp.mean of a bf16 array sums in f32 and rounds the mean
        x = x.float().mean(dim=(2, 3)).to(self.dtype)
        return self.head(x).float()


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2])  # basic-block depths reused as bottlenecks, as the JAX package does
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3])


def flops_per_image(image_size: int = 224) -> float:
    """Approximate fwd FLOPs for ResNet-50 at the given resolution (4.1
    GFLOPs at 224); train step ~= 3x fwd."""
    return 4.1e9 * (image_size / 224.0) ** 2
