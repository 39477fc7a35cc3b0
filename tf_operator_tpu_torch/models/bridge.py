"""Weights for the port's Llama: from a flax parameter tree, or seeded
random ones at full width.

`params_from_jax(cfg, tree)` maps the JAX package's flax Llama params
(a nested dict of numpy arrays, e.g. `jax.tree.map(np.asarray, params)`)
onto the port's state-dict names.  The layouts are already the same, so
the map is a rename plus the storage dtype: cfg.dtype for the embedding
and every projection (flax's DenseGeneral(dtype=...) casts its f32
kernel to that before each product), f32 for the RMSNorm scales and
the lm_head (flax runs it as an f32 Dense).

`init_params(cfg, seed, device)` draws the same state dict on the device
with flax's default initializers — truncated-normal lecun (variance
1/fan_in) for every projection, normal(1/sqrt(d_model)) for the
embedding, ones for the norm scales — so a full-depth bf16 model of
random weights keeps finite activations through all its layers.  The
draws come from a torch.Generator seeded with `seed`: the same seed gives
the same weights on the same device, not the JAX package's weights.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Union

import torch

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models.llama import Llama, LlamaConfig

# flax's truncated_normal divides the std by this so that the truncated
# distribution (bounds +-2) keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def params_from_jax(cfg: LlamaConfig,
                    tree: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict (CPU tensors) from a flax Llama param tree
    of numpy arrays.  Raises KeyError naming the missing flax path for
    trees the port does not take (tied embeddings, MoE blocks)."""
    def t(a, dtype):
        return torch.tensor(a).to(dtype)  # a copy: flax arrays are read-only

    dt, f32 = cfg.dtype, torch.float32
    sd = {"embed": t(tree["embed"]["embedding"], dt),
          "ln_f.scale": t(tree["ln_f"]["scale"], f32),
          "lm_head": t(tree["lm_head"]["kernel"], f32)}
    for i in range(cfg.n_layers):
        blk, p = tree[f"block{i}"], f"blocks.{i}."
        sd[p + "ln1.scale"] = t(blk["ln1"]["scale"], f32)
        sd[p + "ln2.scale"] = t(blk["ln2"]["scale"], f32)
        for name in ("wq", "wkv", "out"):
            sd[p + "attn." + name] = t(blk["attn"][name]["kernel"], dt)
        for name in ("wi", "wo"):
            sd[p + "mlp." + name] = t(blk["mlp"][name]["kernel"], dt)
    return sd


def _fan_in(name: str, shape) -> int:
    if name.endswith("attn.out"):
        return shape[0] * shape[1]  # [H, D, E] contracts H and D
    return shape[0]


def _trunc_normal_(t: torch.Tensor, std: float,
                   generator: torch.Generator) -> torch.Tensor:
    """In place: normal(0, std) truncated to +-2 std, by the inverse CDF
    of a uniform draw (what torch.nn.init.trunc_normal_ does, written
    out so that it takes the generator on every torch version)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    t.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    t.erfinv_().mul_(std * math.sqrt(2.0))
    return t.clamp_(-2.0 * std, 2.0 * std)


def init_params(cfg: LlamaConfig, seed: int,
                device: Union[str, torch.device, None] = None
                ) -> Dict[str, torch.Tensor]:
    """Random weights for `cfg` drawn on `device` (default "cuda") from
    a generator seeded with `seed`, in the port's storage dtypes."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.device("meta"):
        spec = {k: (tuple(v.shape), v.dtype)
                for k, v in Llama(cfg).state_dict().items()}
    sd = {}
    for name, (shape, dtype) in spec.items():
        if name.endswith(".scale"):
            sd[name] = torch.ones(shape, dtype=dtype, device=dev)
            continue
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        if name == "embed":
            w.normal_(0.0, 1.0 / math.sqrt(cfg.d_model), generator=gen)
        else:
            std = 1.0 / math.sqrt(_fan_in(name, shape)) / _TRUNC_STD
            _trunc_normal_(w, std, gen)
        sd[name] = w.to(dtype)
    return sd
