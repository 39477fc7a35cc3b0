"""Tensor-parallel (Megatron-style) + expert + fsdp parameter placement
for the transformer family, as specs over the port's state-dict names.

The port of tf_operator_tpu/parallel/tp.py's `_overlay_fsdp`,
`transformer_param_sharding` and `state_sharding`.  The rule table is
the JAX package's, matched on each parameter's flax path (`jax_path`:
`blocks.0.attn.wq` is `block0/attn/wq/kernel`): column-parallel qkv, wq,
wkv and wi shard their output features over tp, row-parallel out and wo
their input features, the embedding its vocab rows and an untied
lm_head its vocab columns; experts shard over ep; every parameter then
overlays fsdp on its largest free dim divisible by the fsdp size
(parallel/mesh.pick_fsdp_dim), from min_fsdp_size elements up.  A rule
whose dim does not divide replicates.

`state_sharding` places a train state as JAX's does: the parameters by
the table, each optimizer-state leaf by the spec of the FIRST parameter
(in flax's sorted tree order) of the same shape, and scalars and shapes
no parameter has replicated.

`kv_cache_sharding` places the decode KV cache as JAX's does: kv heads
over tp where they divide it, the batch over the data axes where it
divides them, every other dim (the positions above all) whole.  Where
JAX holds a `NamedSharding`, the port holds a `KvCacheSharding`: the
mesh, the spec, and the head counts that say which kv heads this rank's
cache holds (`kv_heads_of`).  Where the kv heads do not divide tp, JAX
replicates the cache; each rank of the port holds only the kv heads its
own query heads read, the ones the model computes (models/llama).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from tf_operator_tpu_torch.models.quant import QTensor
from tf_operator_tpu_torch.parallel.mesh import (
    Mesh, Spec, local_shape, pick_fsdp_dim)

# the flax leaves that are a Dense kernel (the others are raw params)
_KERNELS = ("wq", "wkv", "out", "qkv", "wi", "wo", "router", "lm_head")


def jax_path(name: str) -> Tuple[str, ...]:
    """The flax path of the port's state-dict name `name` (the Llama and
    Transformer families): blocks.{i} -> block{i}, the embedding table
    -> embed/embedding, a Dense parameter -> .../kernel (an expert
    bank's raw wi / wo and pos_embed stay bare)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        parts = [f"block{parts[1]}"] + parts[2:]
    if parts == ["embed"]:
        return ("embed", "embedding")
    bank = len(parts) > 1 and parts[-2] == "moe" and parts[-1] != "router"
    if parts[-1] in _KERNELS and not bank:
        parts.append("kernel")
    return tuple(parts)


def _overlay_fsdp(spec_list, shape, fsdp: int, min_size: int):
    taken = tuple(d for d, s in enumerate(spec_list) if s is not None)
    d = pick_fsdp_dim(shape, fsdp, min_size, taken=taken)
    if d is not None:
        spec_list[d] = "fsdp"
    return spec_list


def param_spec(name: str, shape, mesh: Mesh, min_fsdp_size: int = 2**14
               ) -> Spec:
    """One parameter's spec by the JAX package's rule table."""
    path = "/".join(jax_path(name))
    tp = mesh.shape.get("tp", 1)
    ep = mesh.shape.get("ep", 1)
    fsdp = mesh.shape.get("fsdp", 1)
    shape = tuple(shape)
    spec = [None] * len(shape)

    def ok(dim, axis_size):
        return dim < len(shape) and shape[dim] % axis_size == 0

    if tp > 1:
        if path.endswith("qkv/kernel") and ok(2, tp):
            spec[2] = "tp"  # [E, 3, H, D]: shard heads
        elif path.endswith("attn/wq/kernel") and ok(1, tp):
            spec[1] = "tp"  # llama [E, H, D]: shard query heads
        elif path.endswith("attn/wkv/kernel") and ok(2, tp):
            spec[2] = "tp"  # llama [E, 2, KV, D]: shard kv heads
        elif "attn/out/kernel" in path and ok(0, tp):
            spec[0] = "tp"  # [H, D, E]: row-parallel
        elif (path.endswith("mlp/wi/kernel") and len(shape) == 3
                and ok(2, tp)):
            spec[2] = "tp"  # llama swiglu [E, 2, F]: column-parallel
        elif path.endswith("mlp/wi/kernel") and ok(1, tp):
            spec[1] = "tp"  # [E, F]: column-parallel
        elif path.endswith("mlp/wo/kernel") and ok(0, tp):
            spec[0] = "tp"  # [F, E]: row-parallel
        elif path.endswith("embed/embedding") and ok(0, tp):
            spec[0] = "tp"  # vocab-parallel embedding
        elif path.endswith("lm_head/kernel") and ok(1, tp):
            spec[1] = "tp"
        elif path.endswith("moe/wi") and ok(2, tp):
            spec[2] = "tp"  # [X, D, F]
        elif path.endswith("moe/wo") and ok(1, tp):
            spec[1] = "tp"  # [X, F, D]
    if ep > 1 and ("moe/wi" in path or "moe/wo" in path) and ok(0, ep):
        spec[0] = "ep"  # experts over ep
    return tuple(_overlay_fsdp(spec, shape, fsdp, min_fsdp_size))


def transformer_param_sharding(params: Mapping[str, Any], mesh: Mesh,
                               min_fsdp_size: int = 2**14) -> Dict[str, Any]:
    """{name: spec} for a state dict of the Llama or Transformer family
    (tensors, meta tensors or shapes).  A quantized leaf (QTensor) places
    by the same table: the int8 payload takes its parameter's spec, and
    the per-output-channel scale the payload's spec on every dim it
    actually carries (its size-1 dims replicate); the value is then a
    QTensor of the two specs."""
    out = {}
    for name, x in params.items():
        shape = tuple(getattr(x, "shape", x))
        spec = param_spec(name, shape, mesh, min_fsdp_size)
        if isinstance(x, QTensor):
            out[name] = QTensor(q=spec,
                                scale=scale_spec(spec, x.scale.shape, mesh))
        else:
            out[name] = spec
    return out


def scale_spec(spec: Spec, scale_shape, mesh: Mesh) -> Spec:
    """A QTensor scale's spec under its payload's `spec`: the payload's
    axis on every dim the scale carries (its size-1 broadcast dims
    replicate)."""
    return tuple(a if a is not None and scale_shape[d] % mesh.shape[a] == 0
                 else None for d, a in enumerate(spec))


def kv_heads_of(n_heads: int, n_kv_heads: int, rank: int, tp: int
                ) -> List[int]:
    """The kv heads that tp rank `rank` of `tp` computes and caches: its
    contiguous chunk where n_kv_heads divides tp; else (JAX replicates
    the cache) the kv heads its n_heads / tp query heads read, one per
    query group when every kv head serves the same number of them, else
    one per query head."""
    if tp <= 1:
        return list(range(n_kv_heads))
    if n_kv_heads % tp == 0:
        n = n_kv_heads // tp
        return list(range(rank * n, (rank + 1) * n))
    h = n_heads // tp
    ids = [(rank * h + i) // (n_heads // n_kv_heads) for i in range(h)]
    uniq = sorted(set(ids))
    per = h // len(uniq)
    if h % len(uniq) == 0 and ids == [u for u in uniq for _ in range(per)]:
        return uniq
    return ids


@dataclass(frozen=True)
class KvCacheSharding:
    """The placement of a decode KV cache ([B, C, KV, D] rings, or a
    block pool [N+1, bs, KV, D] under models/serving's `_pool_sharding`):
    the port's
    NamedSharding.  `spec` is JAX's; n_heads / n_kv_heads are the
    model's, which say the kv heads this rank holds."""

    mesh: Mesh
    spec: Spec
    n_heads: int
    n_kv_heads: int

    def kv_heads(self) -> Optional[List[int]]:
        """The kv heads this rank's cache holds, in order (None: all)."""
        tp = self.mesh.shape["tp"]
        if tp == 1:
            return None
        return kv_heads_of(self.n_heads, self.n_kv_heads,
                           self.mesh.coords()["tp"], tp)

    def local_shape(self, shape) -> Tuple[int, ...]:
        """This rank's block of a cache leaf of the whole `shape`: the
        batch (or block) dim by the spec, the kv heads this rank
        holds."""
        out = list(local_shape(shape[:2], self.spec[:2], self.mesh))
        heads = self.kv_heads()
        return tuple(out) + ((shape[2] if heads is None else len(heads)),
                             ) + tuple(shape[3:])


def kv_cache_sharding(cfg, mesh: Mesh, batch: int) -> KvCacheSharding:
    """Sharding for the decode KV cache (models/llama.init_cache leaves,
    [B, C, KV, D]): kv heads over tp (each rank holds only its own
    heads' K/V, the stream that dominates long-context decode) and the
    batch over the data axes (dcn/dp/fsdp) when it divides them.  Axes
    that do not divide replicate rather than refuse: a 70B model with 8
    kv heads on a tp=16 mesh still serves.  The positions dim is never
    sharded: every decode step writes one slot at a dynamic position."""
    tp = mesh.shape.get("tp", 1)
    data_axes = tuple(a for a in ("dcn", "dp", "fsdp")
                      if mesh.shape.get(a, 1) > 1)
    n_data = 1
    for a in data_axes:
        n_data *= mesh.shape[a]
    spec_b = data_axes if data_axes and batch % n_data == 0 else None
    spec_kv = "tp" if tp > 1 and cfg.n_kv_heads % tp == 0 else None
    return KvCacheSharding(mesh, (spec_b, None, spec_kv, None),
                           cfg.n_heads, cfg.n_kv_heads)


def check_cache_sharding(name: str, sharding) -> KvCacheSharding:
    """A cache sharding argument must be one KvCacheSharding, broadcast
    over every cache leaf; the refusal names where to make one."""
    if not isinstance(sharding, KvCacheSharding):
        raise ValueError(
            f"{name} must be a single KvCacheSharding broadcast over "
            f"every cache leaf (parallel/tp.kv_cache_sharding), got "
            f"{type(sharding).__name__}")
    return sharding


@dataclass
class StateSharding:
    """The specs of a TrainState's parts (JAX's TrainState of
    NamedShardings): the step, {name: spec} of the parameters, the
    optimizer state's tree with a spec at each tensor, and {name: ()} of
    the batch statistics."""

    step: Spec
    params: Dict[str, Spec]
    opt_state: Any
    batch_stats: Dict[str, Spec]


def _shape(x) -> Tuple[int, ...]:
    return tuple(getattr(x, "shape", ()))


def opt_state_sharding(opt_state, params: Mapping[str, Any],
                       param_specs: Mapping[str, Spec]):
    """The optimizer state's specs: a tensor of a parameter's shape takes
    the spec of the first parameter of that shape in flax's tree order
    (keys sorted level by level); scalars, counts and other shapes
    replicate."""
    first: Dict[Tuple[int, ...], Spec] = {}
    for name in sorted(params, key=jax_path):
        first.setdefault(_shape(params[name]), param_specs[name])

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        shape = _shape(x)
        if not shape:
            return ()
        return first.get(shape, ())

    return place(opt_state)


def state_sharding(state, mesh: Mesh,
                   param_fn: Callable = transformer_param_sharding
                   ) -> StateSharding:
    """Sharding for a TrainState (runtime/train.TrainState, its tensors
    at their whole shapes; meta tensors do): params + mirrored opt_state,
    scalars replicated."""
    params_sh = param_fn(state.params, mesh)
    return StateSharding(
        step=(),
        params=params_sh,
        opt_state=opt_state_sharding(state.opt_state, state.params,
                                     params_sh),
        batch_stats={k: () for k in state.batch_stats})


def shapes_of(params: Mapping[str, torch.Tensor]) -> Dict[str, Tuple]:
    return {k: _shape(v) for k, v in params.items()}
