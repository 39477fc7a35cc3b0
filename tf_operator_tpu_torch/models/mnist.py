"""MNIST models in PyTorch — benchmark ladder configs #1/#2.

The port of tf_operator_tpu/models/mnist.py (`MnistCNN`, `MnistMLP`)
over the flax-style layers of models/flax_layers.py: NHWC input cast to
`dtype`, "SAME" 5x5 convolutions with biases, 2x2 "VALID" max pools, the
feature map flattened in NHWC order (as flax reshapes it, so the Dense
kernels carry across unchanged) and an f32 output layer.  The input
size is fixed when the model is built (flax infers the first Dense's
width from the first input).  Submodule names are flax's automatic ones
(`Conv_0`, `Dense_0`, ...).
"""
from __future__ import annotations

import torch
from torch import nn

from tf_operator_tpu_torch.models.flax_layers import (
    Conv, Dense, flatten_nhwc, max_pool, nhwc_to_nchw)


class MnistCNN(nn.Module):
    """Conv net in the spirit of the reference's dist_mnist example:
    forward(x [B, H, W, 1] or [B, H, W]) -> f32 logits."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16, image_size: int = 28,
                 channels: int = 1) -> None:
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(channels, 32, (5, 5), dtype=dtype)
        self.Conv_1 = Conv(32, 64, (5, 5), dtype=dtype)
        side = image_size // 2 // 2
        self.Dense_0 = Dense(side * side * 64, 1024, dtype=dtype)
        self.Dense_1 = Dense(1024, num_classes, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        x = nhwc_to_nchw(x, self.dtype)
        x = max_pool(torch.relu(self.Conv_0(x)), (2, 2), (2, 2))
        x = max_pool(torch.relu(self.Conv_1(x)), (2, 2), (2, 2))
        x = torch.relu(self.Dense_0(flatten_nhwc(x)))
        return self.Dense_1(x).float()


class MnistMLP(nn.Module):
    def __init__(self, num_classes: int = 10, hidden: int = 128,
                 dtype: torch.dtype = torch.bfloat16, image_size: int = 28,
                 channels: int = 1) -> None:
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = Dense(image_size * image_size * channels, hidden,
                             dtype=dtype)
        self.Dense_1 = Dense(hidden, num_classes, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        return self.Dense_1(torch.relu(self.Dense_0(x))).float()
