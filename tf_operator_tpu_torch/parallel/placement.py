"""Applying a sharding: a model whose every rank holds exactly its
shard, and the step's reductions over the mesh.

`place(model, mesh, specs, params, device)` takes a model built on the
meta device at its whole shapes (the Llama or Transformer family), the
mesh (parallel/mesh), {name: spec} (parallel/tp.state_sharding's
params) and the whole parameters (a mapping, or (name, tensor) pairs one
leaf at a time, e.g. models/bridge's draws), and leaves on each rank the
block jax.device_put would put on its device: JAX's layout, replicated
leaves included.  A quantized leaf (models/quant.QTensor, e.g. from
bridge.iter_int8_params) places as transformer_param_sharding's QTensor
branch says: the int8 payload by the parameter's spec, its
`<name>_scale` buffer by the dims the scale carries (its broadcast
size-1 dims whole), and models/llama._dense dequantizes the rank's
block at each use.  How the model computes on those blocks:

  - tp, Megatron-style on local slices.  Each rank's modules hold their
    slice of every tp-sharded weight and compute on their heads, their
    MLP columns and their vocab rows; `Tp.enter` / `Tp.exit`
    (parallel/comm) carry the collectives at the edges of each parallel
    region.  The flax layouts stay ([E, H, D] wq, [E, 2, KV, D] wkv,
    [H, D, E] out, [E, 2, F] wi), so the slices are JAX's.  A wkv that
    JAX replicates (KV does not divide tp) stays whole and each rank
    reads the kv heads of its own query groups.  Mixtral's packed
    [X, D, 2F] expert wi, whose tp chunk holds gate columns on one rank
    and up columns on another, is gathered over tp at each use and this
    rank's gate and up columns kept.
  - fsdp, just in time: a weight sharded over fsdp is a
    torch.nn.utils.parametrize parametrization whose `original` is the
    shard; each read gathers it over the fsdp group (parallel/comm
    .gather_param), and the backward sums the members' gradients into
    each shard.  Under remat the recompute gathers again.

  - pp: no rule maps a model dim to pp, so every leaf replicates over
    it and the batch splits over the data axes alone, as JAX's GSPMD
    path places a model on a mesh with a pp axis; the pp members of a
    data member compute alike (the pipelined models, models/pipeline,
    place their stages themselves: parallel/pp).
  - ep: the expert banks (moe.wi, moe.wo, and their int8 scales) hold
    this rank's block of experts along dim 0, JAX's ep rule; the
    dispatch function (parallel/ep.make_switch_moe) sends each expert's
    tokens to the rank holding it.  Everything else is replicated over
    ep, and the ep members of one data member compute it alike on the
    same rows.

After the backward, `reduce_gradients_` completes every shard's
gradient: the leaves that are replicated over tp but used inside a
parallel region (a replicated wkv, LoRA's adapters) sum over tp, and
every leaf sums over the batch axes (dcn, dp, fsdp) it is not sharded
over and is divided by the number of data members, so each gradient is
the global batch's mean.  Nothing sums over ep: an expert block's
gradient is whole on the rank holding it (the all-to-all brings it every
ep member's tokens), and the ep members' gradients of a replicated leaf
are equal, each already whole (the dispatch's gathers over ep sum its
blocks' gradients in their backward).  `Placement` also carries what
the optimizer (runtime/optim) and the Checkpointer (runtime/train) need:
each leaf's
whole shape and spec, its optimizer state's specs, `redistribute`
between two specs, means and RMS over sharded dims, and `full` / shard
for the checkpoint files.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple, Union

import torch
from torch import nn
from torch.nn.utils import parametrize

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.parallel import comm, dp
from tf_operator_tpu_torch.parallel.mesh import (
    AXIS_ORDER, BATCH_AXES, Mesh, Spec, local_shape, shard_of, spec_axes,
    spec_mesh_axes)
from tf_operator_tpu_torch.models.quant import QTensor
from tf_operator_tpu_torch.parallel.tp import (
    opt_state_sharding, scale_spec, transformer_param_sharding)

# weights a tp region computes on: each must be tp-sharded for the
# Megatron split, except the llama wkv (its kv heads may replicate)
_TP_SPLIT = ("attn.wq", "attn.out", "attn.qkv", "mlp.wi", "mlp.wo",
             "moe.wi", "moe.wo")


class _FsdpGather(nn.Module):
    """Parametrization: the fsdp shard -> the weight gathered over
    fsdp along `dim`."""

    def __init__(self, group, dim: int) -> None:
        super().__init__()
        self.group, self.dim = group, dim

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        return comm.gather_param(w, self.group, self.dim)


class _SwigluColumns(nn.Module):
    """Parametrization of a packed [X, D, 2F] swiglu expert wi whose last
    dim is split contiguously over tp: the whole over tp, then this
    rank's gate and up columns ([X, D, 2F/tp], gate half first)."""

    def __init__(self, tp: comm.Tp, cols: torch.Tensor) -> None:
        super().__init__()
        self.tp = tp
        self.register_buffer("cols", cols, persistent=False)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        full = comm.gather_param(w, self.tp.group, 2)
        return full.index_select(2, self.cols)


def _swiglu_cols(two_f: int, tp: comm.Tp, device) -> torch.Tensor:
    f = two_f // 2
    n = f // tp.size
    mine = torch.arange(tp.rank * n, (tp.rank + 1) * n, device=device)
    return torch.cat([mine, f + mine])


class Placement:
    """A model's sharding over `mesh`: {name: spec} and {name: whole
    shape} of its parameters, the tp group its modules use (None at
    tp 1), the leaves whose gradient sums over tp, and the optimizer
    state's specs once a TrainState is made (`init_opt_state`)."""

    def __init__(self, mesh: Mesh, specs: Mapping[str, Spec],
                 shapes: Mapping[str, Tuple[int, ...]]) -> None:
        self.mesh = mesh
        self.specs = {k: tuple(v) for k, v in specs.items()}
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        self.tp_partial = set()
        # int8 weights: {name: the spec of its `<name>_scale` buffer}
        self.scale_specs: Dict[str, Spec] = {}
        self.views: Dict[str, Callable] = {}
        self.opt_specs = None
        n_tp = mesh.shape["tp"]
        self.tp = (comm.Tp(mesh.group("tp"), mesh.coords()["tp"], n_tp)
                   if n_tp > 1 else None)
        # the ep group an expert bank's blocks are gathered over to
        # decode one token (models/llama.MoeSwiGlu); None at ep 1
        self.ep = mesh.group("ep")
        self.batch_group = mesh.group(BATCH_AXES)
        self.n_data = mesh.axis_size(BATCH_AXES)

    def __repr__(self) -> str:
        return f"Placement({self.mesh}, {len(self.specs)} leaves)"

    # ----------------------------------------------------------- specs
    def spec(self, name: str) -> Spec:
        return self.specs.get(name, ())

    def shape(self, name: str, local: Optional[torch.Tensor] = None
              ) -> Tuple[int, ...]:
        return self.shapes.get(name, tuple(local.shape) if local is not None
                               else ())

    def opt_spec(self, kind: str, name: str) -> Spec:
        return self.opt_specs[kind][name] if self.opt_specs else ()

    def data_index(self) -> Tuple[int, int]:
        """(this rank's data member, the number of members): its
        coordinate over the batch axes."""
        return self.mesh.axis_index(BATCH_AXES), self.n_data

    # ------------------------------------------------------- the model
    def params(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """{name: this rank's shard} (a parametrized weight's original)."""
        out = {}
        for name in self.specs:
            mod_name, _, attr = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            if parametrize.is_parametrized(mod, attr):
                out[name] = mod.parametrizations[attr].original
            else:
                out[name] = getattr(mod, attr)
        return out

    def init_opt_state(self, tx, params: Mapping[str, torch.Tensor]):
        """tx's initial state for `params` (this rank's shards), each
        leaf the shard of the whole state that JAX's state_sharding
        places (parallel/tp.opt_state_sharding); records the specs."""
        meta = {k: torch.empty(self.shape(k, p), dtype=p.dtype,
                               device="meta") for k, p in params.items()}
        whole = tx.init(meta)
        self.opt_specs = opt_state_sharding(
            whole, meta, {k: self.spec(k) for k in params})
        dev = next(iter(params.values())).device

        def make(x, s):
            if isinstance(x, dict):
                return {k: make(v, s[k]) for k, v in x.items()}
            if isinstance(x, torch.Tensor):
                return torch.zeros(local_shape(x.shape, s, self.mesh),
                                   dtype=x.dtype, device=dev)
            return x

        return make(whole, self.opt_specs)

    # ----------------------------------------------------- collectives
    def group(self, axes):
        return self.mesh.group(tuple(a for a in AXIS_ORDER if a in axes))

    def redistribute(self, t: torch.Tensor, src: Spec, dst: Spec
                     ) -> torch.Tensor:
        """`t` (this rank's block under `src`) as its block under `dst`:
        gathered along the dims `src` shards and `dst` does not, then
        narrowed to the chunks `dst` gives this rank."""
        src = tuple(src) + (None,) * (t.dim() - len(src))
        dst = tuple(dst) + (None,) * (t.dim() - len(dst))
        for d, (a, b) in enumerate(zip(src, dst)):
            a, b = spec_axes(a), spec_axes(b)
            if a == b:
                continue
            if a:
                t = comm.all_gather_cat(t, self.group(a), d)
            if b:
                k = self.mesh.axis_size(b)
                w = t.shape[d] // k
                t = t.narrow(d, self.mesh.axis_index(b) * w, w)
        return t

    def mean(self, x: torch.Tensor, dim: int, spec: Spec, whole: int,
             keepdim: bool = False) -> torch.Tensor:
        """x's mean over `dim` of its whole extent `whole`: over a dim
        `spec` shards, the local sums added over the ranks holding the
        pieces."""
        axes = spec_axes(spec[dim]) if dim < len(spec) else ()
        if self.mesh.axis_size(axes) == 1:
            return x.mean(dim=dim, keepdim=keepdim)
        s = x.sum(dim=dim, keepdim=keepdim)
        comm.all_reduce_(s, self.group(axes))
        return s / whole

    def rms(self, x: torch.Tensor, spec: Spec, numel: int) -> torch.Tensor:
        """sqrt(mean(x²)) over the whole leaf x is a block of."""
        axes = spec_mesh_axes(spec)
        if self.mesh.axis_size(axes) == 1:
            return torch.sqrt(torch.mean(x * x))
        s = torch.sum(x * x)
        comm.all_reduce_(s, self.group(axes))
        return torch.sqrt(s / numel)

    def full(self, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        """The whole leaf from every rank's block (every rank calls)."""
        for d, entry in enumerate(spec):
            axes = spec_axes(entry)
            if axes:
                t = comm.all_gather_cat(t, self.group(axes), d)
        return t

    def shard(self, whole: torch.Tensor, spec: Spec) -> torch.Tensor:
        return shard_of(whole, spec, self.mesh)

    # -------------------------------------------------------- the step
    @torch.no_grad()
    def reduce_gradients_(self, params: Mapping[str, torch.Tensor]) -> None:
        """Every shard's .grad made the global batch's mean gradient of
        that block (module docstring); a parameter with no gradient
        takes zeros first, so every rank sends the same buckets."""
        for p in params.values():
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)
        named = [(k, p.grad) for k, p in params.items() if p.grad is not None]
        if self.tp is not None:
            _bucketed([g for k, g in named if k in self.tp_partial],
                      self.tp.group)
        by_axes: Dict[Tuple[str, ...], list] = {}
        for k, g in named:
            axes = tuple(a for a in BATCH_AXES
                         if a not in spec_mesh_axes(self.spec(k)))
            by_axes.setdefault(axes, []).append(g)
        for axes, grads in by_axes.items():
            _bucketed(grads, self.group(axes))
            if self.n_data > 1:
                for g in grads:
                    g.div_(self.n_data)

    @torch.no_grad()
    def grad_norm(self, params: Mapping[str, torch.Tensor]) -> float:
        """The global gradient norm (every element of every whole leaf
        counted once), in f64."""
        world = self.mesh.size
        total = None
        for k, p in params.items():
            if p.grad is None:
                continue
            held = self.mesh.axis_size(spec_mesh_axes(self.spec(k)))
            s = p.grad.double().pow(2).sum() * (held / world)
            total = s if total is None else total + s
        comm.all_reduce_(total, self.group(AXIS_ORDER))
        return math.sqrt(float(total))


def _bucketed(grads, group) -> None:
    """Sum `grads` over `group` in place, bucket by bucket."""
    if group is None or not grads:
        return
    for run in dp._buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in run])
        comm.all_reduce_(flat, group)
        offset = 0
        for g in run:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def _block(whole: torch.Tensor, spec: Spec, mesh: Mesh, dtype, dev
           ) -> torch.Tensor:
    """This rank's block of `whole` under `spec`, a fresh tensor of
    `dtype` on `dev`."""
    block = shard_of(whole, spec, mesh)
    local = torch.empty(block.shape, dtype=dtype, device=dev)
    local.copy_(block)
    return local


def _pairs(params) -> Iterable[Tuple[str, torch.Tensor]]:
    return params.items() if isinstance(params, Mapping) else params


def place(model: nn.Module, mesh: Mesh, specs: Mapping[str, Spec],
          params: Union[Mapping[str, torch.Tensor],
                        Iterable[Tuple[str, torch.Tensor]]],
          device=None, requires_grad: bool = True) -> Placement:
    """Fill `model` (built on the meta device at its whole shapes) with
    this rank's blocks of `params` on `device` (default "cuda"), in the
    model's storage dtypes, and set up its fsdp gathers and its tp
    group (module docstring).  Returns the Placement, also kept as
    `model.placement`."""
    dev = resolve_device(device)
    want = {k: (tuple(v.shape), v.dtype)
            for k, v in model.state_dict().items()}
    if set(specs) != set(want):
        raise ValueError(
            f"specs do not match the model: missing "
            f"{sorted(set(want) - set(specs))[:5]}, unexpected "
            f"{sorted(set(specs) - set(want))[:5]}")
    pl = Placement(mesh, {k: v.q if isinstance(v, QTensor) else v
                          for k, v in specs.items()},
                   {k: s for k, (s, _) in want.items()})
    _check_tp(pl)
    seen = set()
    for name, whole in _pairs(params):
        shape, dtype = want[name]
        if tuple(whole.shape) != shape:
            raise ValueError(f"{name}: {tuple(whole.shape)} != {shape}")
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        if isinstance(whole, QTensor):
            # int8 serving weights: the payload takes the parameter's
            # spec, its scale buffer the dims it carries
            sspec = (specs[name].scale if isinstance(specs[name], QTensor)
                     else scale_spec(pl.spec(name), whole.scale.shape, mesh))
            pl.scale_specs[name] = sspec
            setattr(mod, attr, nn.Parameter(
                _block(whole.q, pl.spec(name), mesh, torch.int8, dev),
                requires_grad=False))
            mod.register_buffer(attr + "_scale", _block(
                whole.scale, sspec, mesh, torch.float32, dev))
        else:
            setattr(mod, attr, nn.Parameter(
                _block(whole, pl.spec(name), mesh, dtype, dev),
                requires_grad=requires_grad))
        seen.add(name)
    if seen != set(want):
        raise ValueError(f"params lack {sorted(set(want) - seen)[:5]}")
    for name, spec in pl.specs.items():
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        leaves = [(attr, spec)]
        if name in pl.scale_specs:
            leaves.append((attr + "_scale", pl.scale_specs[name]))
        packed = (name.endswith("moe.wi")
                  and getattr(mod, "packed_swiglu", False))
        pl.views[name] = _tp_view(name, spec, pl, dev, packed)
        for leaf, lspec in leaves:
            for d, entry in enumerate(lspec):
                if "fsdp" in spec_axes(entry):
                    parametrize.register_parametrization(
                        mod, leaf, _FsdpGather(mesh.group("fsdp"), d),
                        unsafe=True)
            if (pl.tp is not None and packed
                    and "tp" in spec_axes(lspec[2])):
                parametrize.register_parametrization(
                    mod, leaf, _SwigluColumns(pl.tp, _swiglu_cols(
                        pl.shapes[name][2], pl.tp, dev)), unsafe=True)
    for mod in model.modules():
        if hasattr(type(mod), "tp"):
            mod.tp = pl.tp
        if hasattr(type(mod), "ep"):
            mod.ep = pl.ep
    model.placement = pl
    return pl


def _check_tp(pl: Placement) -> None:
    """Refuse a tp split the modules cannot compute on local slices; note
    the replicated leaves a parallel region uses (their gradients sum
    over tp)."""
    if pl.tp is None:
        return
    for name, spec in pl.specs.items():
        sharded = any("tp" in spec_axes(e) for e in spec)
        if name.endswith(_TP_SPLIT) and not sharded:
            raise ValueError(
                f"{name} {pl.shapes[name]} does not divide over tp "
                f"{pl.tp.size} (the rule replicates it): the heads, the "
                f"MLP width and the experts' width must divide by tp")
        if name.endswith("attn.wkv") and not sharded:
            pl.tp_partial.add(name)


def _tp_view(name: str, spec: Spec, pl: Placement, dev,
             packed: bool) -> Callable:
    """whole -> the part of it this rank's modules compute with: the tp
    chunk along the dim spec shards over tp, the gate and up columns of
    a packed expert wi, or all of it."""
    if pl.tp is None:
        return lambda w: w
    for d, entry in enumerate(spec):
        if "tp" in spec_axes(entry):
            if packed and d == 2:
                n2f = pl.shapes[name][2]
                cols = _swiglu_cols(n2f, pl.tp, dev)
                return lambda w: w.index_select(2, cols.to(w.device))
            n = pl.shapes[name][d] // pl.tp.size
            return lambda w, d=d, n=n: w.narrow(d, pl.tp.rank * n, n)
    return lambda w: w


def shard_model(model: nn.Module, mesh: Mesh, params, device=None,
                min_fsdp_size: int = 2**14,
                requires_grad: bool = True) -> Placement:
    """`place` under the JAX package's transformer rule table
    (parallel/tp.transformer_param_sharding of the model's whole
    shapes): what state_sharding gives a Llama or Transformer state."""
    specs = transformer_param_sharding(
        {k: tuple(v.shape) for k, v in model.state_dict().items()}, mesh,
        min_fsdp_size=min_fsdp_size)
    return place(model, mesh, specs, params, device, requires_grad)
