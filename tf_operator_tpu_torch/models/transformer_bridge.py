"""Weights for the port's Transformer: from a flax parameter tree, or
seeded random ones on the device.

`transformer_params_from_jax(cfg, tree)` maps the JAX package's flax
Transformer params (a nested dict of numpy arrays, e.g.
`jax.tree.map(np.asarray, params)`) onto the port's state-dict names
(models/transformer.Transformer).  The layouts are the same, so the map
is a rename; every tensor is f32, the master weights flax's `model.init`
holds.  A sparse block's `moe` subtree (the router kernel and the raw
expert matrices wi and wo) maps to `blocks.{i}.moe.{router,wi,wo}`.

`init_transformer_params(cfg, seed, device)` draws the same state dict
on the device with flax's default initializers: truncated-normal lecun
(variance 1/fan_in) for every projection, where the fan-in is the
product of the input axes (qkv [E, 3, H, D]: E; out [H, D, E]: H·D; the
raw experts [X, E, F] / [X, F, E]: X·E / X·F, as flax's variance
scaling folds the leading axis into the receptive field); the token
embedding normal(1/sqrt(d_model)) (flax Embed's variance scaling, fan-in
d_model); the position table normal(0.02); ones for the LayerNorm
scales.  The draws come from a torch.Generator seeded with `seed`, one
leaf at a time in state-dict order: the same seed gives the same
weights on the same device, not the JAX package's weights.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models.bridge import (
    _TRUNC_STD, _trunc_normal_, init_fan_in)
from tf_operator_tpu_torch.models.transformer import (
    Transformer, TransformerConfig)


def transformer_params_from_jax(cfg: TransformerConfig, tree: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """The port's state dict (f32 CPU tensors) from a flax Transformer
    param tree of numpy arrays."""
    def t(a):
        # a contiguous copy: flax arrays are read-only, imported ones views
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32)

    sd = {"embed": t(tree["embed"]["embedding"]),
          "pos_embed": t(tree["pos_embed"]),
          "ln_f.scale": t(tree["ln_f"]["scale"])}
    if not cfg.tie_embeddings:
        sd["lm_head"] = t(tree["lm_head"]["kernel"])
    for i in range(cfg.n_layers):
        blk, p = tree[f"block{i}"], f"blocks.{i}."
        sd[p + "ln1.scale"] = t(blk["ln1"]["scale"])
        sd[p + "ln2.scale"] = t(blk["ln2"]["scale"])
        for name in ("qkv", "out"):
            sd[p + "attn." + name] = t(blk["attn"][name]["kernel"])
        if "moe" in blk:
            moe = blk["moe"]
            sd[p + "moe.router"] = t(moe["router"]["kernel"])
            sd[p + "moe.wi"] = t(moe["wi"])
            sd[p + "moe.wo"] = t(moe["wo"])
        else:
            for name in ("wi", "wo"):
                sd[p + "mlp." + name] = t(blk["mlp"][name]["kernel"])
    return sd


def init_transformer_params(cfg: TransformerConfig, seed: int,
                            device: Union[str, torch.device, None] = None
                            ) -> Dict[str, torch.Tensor]:
    """f32 random weights for `cfg` drawn on `device` (default "cuda")
    from a generator seeded with `seed`, with flax's initializers."""
    return dict(iter_transformer_params(cfg, seed, device))


def iter_transformer_params(cfg: TransformerConfig, seed: int,
                            device: Union[str, torch.device, None] = None
                            ) -> Iterator[Tuple[str, torch.Tensor]]:
    """init_transformer_params's (name, tensor) pairs, drawn one leaf at
    a time in state-dict order (a sharded model keeps its block of each:
    parallel/placement.place)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.device("meta"):
        spec = {k: tuple(v.shape)
                for k, v in Transformer(cfg).state_dict().items()}
    for name, shape in spec.items():
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        if name.endswith(".scale"):
            w.fill_(1.0)
        elif name == "embed":
            w.normal_(0.0, 1.0 / math.sqrt(cfg.d_model), generator=gen)
        elif name == "pos_embed":
            w.normal_(0.0, 0.02, generator=gen)
        else:
            std = 1.0 / math.sqrt(init_fan_in(name, shape)) / _TRUNC_STD
            _trunc_normal_(w, std, gen)
        yield name, w


def transformer_from_params(cfg: TransformerConfig, params: Mapping,
                            device: Union[str, torch.device, None] = None
                            ) -> Transformer:
    """The Transformer around `params` (a state dict in the port's
    layouts) on `device` (default "cuda"), f32 masters that take
    gradients, in training mode.  Tensors already on the device in f32
    are used as they are, not copied."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Transformer(cfg)
    want = model.state_dict()
    missing, extra = set(want) - set(params), set(params) - set(want)
    if missing or extra:
        raise ValueError(
            f"params do not match the config: missing "
            f"{sorted(missing)[:5]}, unexpected {sorted(extra)[:5]}")
    model.load_state_dict(
        {k: params[k].to(device=dev, dtype=torch.float32) for k in want},
        assign=True)
    for p in model.parameters():
        p.requires_grad_(True)
    return model.train()
