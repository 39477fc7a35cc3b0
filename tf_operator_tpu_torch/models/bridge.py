"""Weights for the port's Llama: from a flax parameter tree, or seeded
random ones at full width.

`params_from_jax(cfg, tree)` maps the JAX package's flax Llama params
(a nested dict of numpy arrays, e.g. `jax.tree.map(np.asarray, params)`)
onto the port's state-dict names.  The layouts are already the same, so
the map is a rename plus the storage dtype.  For serving: cfg.dtype for
the embedding and every projection (flax's DenseGeneral(dtype=...) casts
its f32 kernel to that before each product, so casting once gives the
same bits), f32 for the RMSNorm scales and the lm_head (flax runs it as
an f32 Dense).  A sparse block's `moe` subtree (the f32 router kernel,
the raw expert matrices wi and wo) maps to `blocks.{i}.moe.{router,wi,
wo}`: the router stays f32, as flax's Dense(dtype=f32) runs it, and the
experts take cfg.dtype.  For training (`train=True`): every parameter
in f32, the master weights flax's `model.init` holds.  A tied tree
(cfg.tie_embeddings) has no lm_head: the head is the embedding.  A
quantized tree (the JAX package's quant.quantize_params: leaves that
carry an int8 `q` and an f32 `scale`) bridges to models/quant.QTensor
values with both carried across byte for byte; Llama.from_params builds
an int8-weight model from it.

`init_params(cfg, seed, device)` draws the same state dict on the device
with flax's default initializers — truncated-normal lecun (variance
1/fan_in) for every projection, normal(1/sqrt(d_model)) for the
embedding, ones for the norm scales; the fan-in of a raw [X, D, 2F] or
[X, F, D] expert parameter is X·D or X·F, as flax's variance scaling
folds the leading axis into the receptive field — so a full-depth bf16
model of random weights keeps finite activations through all its
layers.  The
draws come from a torch.Generator seeded with `seed`: the same seed gives
the same weights on the same device, not the JAX package's weights.
`init_int8_params(cfg, seed, device)` gives
quant.quantize_params(init_params(cfg, seed, device, train=True)), bit
for bit, drawing and quantizing one leaf at a time: a model whose f32
tree does not fit the card (mixtral_8x7b's is 186 GB) is built in int8
without it; `iter_int8_params` yields the same leaves one at a time, for
a sharded model to keep its block of each.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models import quant
from tf_operator_tpu_torch.models.llama import Llama, LlamaConfig
from tf_operator_tpu_torch.models.quant import QTensor

# flax's truncated_normal divides the std by this so that the truncated
# distribution (bounds +-2) keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def params_from_jax(cfg: LlamaConfig, tree: Mapping,
                    train: bool = False) -> Dict[str, torch.Tensor]:
    """The port's state dict (CPU tensors) from a flax Llama param tree
    of numpy arrays, in serving storage dtypes or (train=True) all f32."""
    def t(a, dtype):
        if hasattr(a, "q") and hasattr(a, "scale"):  # a quantized leaf
            return QTensor(q=torch.tensor(np.asarray(a.q)),
                           scale=torch.tensor(np.asarray(a.scale)))
        # a contiguous copy: flax arrays are read-only, imported ones views
        return torch.tensor(np.ascontiguousarray(a)).to(dtype)

    f32 = torch.float32
    dt = f32 if train else cfg.dtype
    sd = {"embed": t(tree["embed"]["embedding"], dt),
          "ln_f.scale": t(tree["ln_f"]["scale"], f32)}
    if not cfg.tie_embeddings:
        sd["lm_head"] = t(tree["lm_head"]["kernel"], f32)
    for i in range(cfg.n_layers):
        blk, p = tree[f"block{i}"], f"blocks.{i}."
        sd[p + "ln1.scale"] = t(blk["ln1"]["scale"], f32)
        sd[p + "ln2.scale"] = t(blk["ln2"]["scale"], f32)
        for name in ("wq", "wkv", "out"):
            sd[p + "attn." + name] = t(blk["attn"][name]["kernel"], dt)
        if "moe" in blk:
            moe = blk["moe"]
            sd[p + "moe.router"] = t(moe["router"]["kernel"], f32)
            for name in ("wi", "wo"):
                sd[p + "moe." + name] = t(moe[name], dt)
        else:
            for name in ("wi", "wo"):
                sd[p + "mlp." + name] = t(blk["mlp"][name]["kernel"], dt)
    return sd


def params_to_tree(cfg: LlamaConfig, params: Mapping) -> Dict:
    """The inverse of params_from_jax for float state dicts: the flax
    Llama param tree of f32 numpy arrays (models/convert.export_hf_llama
    takes it)."""
    a = lambda name: params[name].detach().to(torch.float32).cpu().numpy()
    tree = {"embed": {"embedding": a("embed")},
            "ln_f": {"scale": a("ln_f.scale")}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"kernel": a("lm_head")}
    for i in range(cfg.n_layers):
        p = f"blocks.{i}."
        blk = {"ln1": {"scale": a(p + "ln1.scale")},
               "ln2": {"scale": a(p + "ln2.scale")},
               "attn": {n: {"kernel": a(p + "attn." + n)}
                        for n in ("wq", "wkv", "out")}}
        if cfg.use_moe(i):
            blk["moe"] = {"router": {"kernel": a(p + "moe.router")},
                          "wi": a(p + "moe.wi"), "wo": a(p + "moe.wo")}
        else:
            blk["mlp"] = {n: {"kernel": a(p + "mlp." + n)}
                          for n in ("wi", "wo")}
        tree[f"block{i}"] = blk
    return tree


def kernel_dims(name: str) -> Tuple[int, int]:
    """(bank, contracted): how many leading dims of the kernel `name`
    (a state-dict name of the Llama or Transformer family) index a bank
    of experts, and how many after them its product contracts; the rest
    are its fan-out.  The [H, D, E] attention out contracts H and D; an
    [X, D, F] / [X, F, D] expert bank is X kernels contracting D / F;
    every other kernel contracts its first dim."""
    if name.endswith("attn.out"):
        return 0, 2
    if name.endswith(("moe.wi", "moe.wo")):
        return 1, 1
    return 0, 1


def init_fan_in(name: str, shape) -> int:
    """The fan-in of flax's lecun_normal for the kernel `name`: every
    dim before the fan-out, the expert bank's included (a raw [X, D, F]
    parameter has fan-in X·D)."""
    return math.prod(shape[:sum(kernel_dims(name))])


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


def _draws(cfg: LlamaConfig, seed: int, device, train: bool
           ) -> Iterator[Tuple[str, torch.Tensor, torch.dtype]]:
    """(name, f32 draw, storage dtype) of each leaf in state-dict order,
    one leaf at a time, from one generator seeded with `seed`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.device("meta"):
        spec = {k: (tuple(v.shape), v.dtype)
                for k, v in Llama(cfg, train=train).state_dict().items()}
    for name, (shape, dtype) in spec.items():
        if name.endswith(".scale"):
            yield name, torch.ones(shape, dtype=torch.float32,
                                   device=dev), dtype
            continue
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        if name == "embed":
            w.normal_(0.0, 1.0 / math.sqrt(cfg.d_model), generator=gen)
        else:
            std = 1.0 / math.sqrt(init_fan_in(name, shape)) / _TRUNC_STD
            _trunc_normal_(w, std, gen)
        yield name, w, dtype


def iter_params(cfg: LlamaConfig, seed: int,
                device: Union[str, torch.device, None] = None,
                train: bool = False) -> Iterator[Tuple[str, torch.Tensor]]:
    """init_params's (name, tensor) pairs one leaf at a time, each drawn
    on `device` and freed by the caller before the next: what a sharded
    model keeps its block of (parallel/placement.place)."""
    for name, w, dtype in _draws(cfg, seed, device, train):
        yield name, w.to(dtype)


def init_params(cfg: LlamaConfig, seed: int,
                device: Union[str, torch.device, None] = None,
                train: bool = False) -> Dict[str, torch.Tensor]:
    """Random weights for `cfg` drawn on `device` (default "cuda") from
    a generator seeded with `seed`, in the port's serving storage dtypes
    or (train=True) as f32 masters.  The draws are the same either way:
    the serving weights are the training ones cast to cfg.dtype."""
    return {name: w.to(dtype)
            for name, w, dtype in _draws(cfg, seed, device, train)}


def iter_int8_params(cfg: LlamaConfig, seed: int,
                     device: Union[str, torch.device, None] = None
                     ) -> Iterator[Tuple[str, object]]:
    """init_int8_params's (name, QTensor or tensor) pairs one leaf at a
    time: what a sharded int8 model keeps its block of
    (parallel/placement.place), so no rank holds the whole tree."""
    for name, w, _ in _draws(cfg, seed, device, train=True):
        yield name, quant.quantize_leaf(name, w)


def init_int8_params(cfg: LlamaConfig, seed: int,
                     device: Union[str, torch.device, None] = None
                     ) -> Dict[str, object]:
    """quant.quantize_params(init_params(cfg, seed, device, train=True)),
    bit for bit, with one f32 leaf alive at a time: each leaf is drawn,
    quantized (quant.quantize_leaf) and freed before the next."""
    return dict(iter_int8_params(cfg, seed, device))
