"""Weights for the port's vision models from flax variables.

`resnet_params_from_jax(variables)` and `mnist_params_from_jax(variables)`
map the JAX package's flax variables of models/resnet.py or
models/mnist.py ({"params": ..., "batch_stats": ...}, nested dicts of
numpy arrays, e.g. `jax.tree.map(np.asarray, variables)`) onto the
port's state-dict names (models/resnet.ResNet, models/mnist.MnistCNN /
MnistMLP): the flax module path joined by dots, a convolution's
[kh, kw, in, out] `kernel` transposed to torch's [out, in, kh, kw]
`weight` in channels_last memory, a Dense `kernel` [in, out], BatchNorm
`scale` and `bias` as they are, and the running stats `mean` and `var`
from batch_stats.  Every tensor is f32.  The seeded on-device init of
the port's own is models/flax_layers.init_.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flat(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    sd = {}
    for coll in ("params", "batch_stats"):
        for name, a in _flat(variables.get(coll, {})):
            t = torch.tensor(np.ascontiguousarray(a), dtype=torch.float32)
            if name.endswith(".kernel") and t.dim() == 4:
                name = name[:-len("kernel")] + "weight"
                t = t.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
            sd[name] = t
    return sd


def resnet_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ResNet state dict (params and running stats) from the
    flax ResNet's variables."""
    return _from_flax(variables)


def mnist_params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's MnistCNN / MnistMLP state dict from the flax model's
    variables (params only: neither keeps running stats)."""
    return _from_flax(variables)
