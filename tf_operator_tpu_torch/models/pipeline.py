"""Pipelined transformer LM: model-level pipeline parallelism.

The port of tf_operator_tpu/models/pipeline.py.  The transformer-block
stack (models/transformer semantics) runs through the GPipe schedule
(parallel/pp) with Megatron-style tensor parallelism inside each stage:
blocks are plain functions over a dict of tensors whose stage leaves
carry a leading [n_stages, blocks_per_stage, ...] stacking, sharded
("pp", None, ...) with head / ffn dims over "tp" (`stage_param_specs`).
In a job each rank holds one stage's block of them (parallel/pp.place
over `param_shardings`) and a 1/tp slice of every block's heads and ffn;
each tp region opens with `Tp.enter` and the two row-parallel products a
block closes with `Tp.exit` (Megatron's f and g, parallel/comm), the
psums JAX places by hand.  fsdp-sharded stage leaves are gathered once
an apply (`_gather_stage`: comm.gather_param, whose backward sums the
members' gradients into each shard), where JAX gathers at each tick.

The embedding and LM head run outside the pipeline, on every stage of
the rank's rows (they are not shape-preserving).  The batch is split
over ("dp", "fsdp") in both.

MoE inside the pipeline (cfg.n_experts > 0): every block's FFN is a
top-1 switch layer with experts sharded over "ep" and the all-to-all
dispatch of parallel/ep._local_moe running inside each stage; the batch
is also split over "ep", and each data member routes its own tokens at
a capacity from its own token count, as JAX's shard_map does.  The
per-block load-balance aux rides the pipeline's aux accumulator and is
returned next to the logits.  In one process the stage emulates that
split: each microbatch's data members' row blocks are routed apart
(`n_blocks`), through the dense oracle, and their aux averaged.

Parameters are f32 masters; the products cast them to cfg.dtype, once
an apply.  `init_params` draws from an explicit torch.Generator;
`params_from_jax` takes the JAX module's tree (numpy leaves) to the
port's, the weights' bridge of this model and models/pipeline_llama.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

from tf_operator_tpu_torch.models.transformer import (
    TransformerConfig, dot_product_attention, lm_loss)
from tf_operator_tpu_torch.parallel import comm, pp
from tf_operator_tpu_torch.parallel.ep import (
    _local_moe, dense_reference_moe, gelu)
from tf_operator_tpu_torch.parallel.mesh import Mesh


# ---------------------------------------------------------------- params
def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def init_params(gen: torch.Generator, cfg: TransformerConfig,
                n_stages: int) -> Dict:
    """Param tree for the pipelined LM, drawn from `gen` on its device.
    Stage leaves are stacked [n_stages, blocks_per_stage, ...]; embed and
    head leaves are flat.  All params f32 (cast to cfg.dtype at use)."""
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers {cfg.n_layers} not divisible by n_stages {n_stages}")
    _check_supported(cfg)
    lps = cfg.n_layers // n_stages
    e, h, d, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    embed = {"embedding": _normal(gen, (cfg.vocab_size, e), 0.02),
             "pos": _normal(gen, (cfg.max_len, e), 0.02)}
    stages = {
        "ln1": torch.ones((n_stages, lps, e), device=gen.device),
        "qkv": _normal(gen, (n_stages, lps, e, 3, h, d), 1 / math.sqrt(e)),
        "out": _normal(gen, (n_stages, lps, h, d, e), 1 / math.sqrt(h * d)),
        "ln2": torch.ones((n_stages, lps, e), device=gen.device),
    }
    if cfg.n_experts:
        # switch FFN: every block carries a router + per-expert wi/wo
        x = cfg.n_experts
        stages.update(
            router=_normal(gen, (n_stages, lps, e, x), 1 / math.sqrt(e)),
            wi=_normal(gen, (n_stages, lps, x, e, f), 1 / math.sqrt(e)),
            wo=_normal(gen, (n_stages, lps, x, f, e), 1 / math.sqrt(f)))
    else:
        stages.update(
            wi=_normal(gen, (n_stages, lps, e, f), 1 / math.sqrt(e)),
            wo=_normal(gen, (n_stages, lps, f, e), 1 / math.sqrt(f)))
    return {"embed": embed, "stages": stages,
            "ln_f": torch.ones((e,), device=gen.device)}


def params_from_jax(tree, device=None) -> Dict:
    """The JAX module's param tree (array or numpy leaves) as the port's:
    the same names and layouts, f32 tensors on `device` (default the
    CPU)."""
    return pp.tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device or "cpu"), tree)


def _check_supported(cfg: TransformerConfig) -> None:
    """Reject config fields the pipelined model would silently drop."""
    if not cfg.tie_embeddings:
        raise ValueError("pipelined LM supports tied embeddings only")
    if cfg.n_experts and cfg.moe_every != 1:
        # stacked stage leaves must be shape-uniform across blocks, so the
        # pipelined MoE puts a switch FFN in EVERY block
        raise ValueError(
            f"pipelined MoE requires moe_every=1 (every block MoE); got "
            f"moe_every={cfg.moe_every}")
    unsupported = {
        "attention_fn": cfg.attention_fn,
        "moe_dispatch_fn": cfg.moe_dispatch_fn,
        "remat": cfg.remat,
    }
    set_fields = [k for k, v in unsupported.items() if v]
    if set_fields:
        raise ValueError(
            f"pipelined LM does not support config fields {set_fields}; "
            f"use the non-pipelined Transformer (models/transformer.py) "
            f"for custom-attention/remat (MoE: set n_experts + moe_every=1; "
            f"the pipeline places the ep all-to-all itself)")


# per stage-leaf: the dim (in STACKED [pp, L, ...] coordinates) that fsdp
# shards — the model dim E everywhere; ln scales are too small to bother.
# Dense and MoE FFN leaves share names but differ in rank, hence two tables.
_FSDP_DIMS_DENSE = {
    "qkv": 2, "out": 4, "wi": 2, "wo": 3, "ln1": None, "ln2": None,
}
_FSDP_DIMS_MOE = {
    "qkv": 2, "out": 4, "wi": 3, "wo": 4, "ln1": None, "ln2": None,
    "router": None,  # [pp, L, e, E] — small; replicated like the ln scales
}


def _fsdp_dims(moe: bool) -> Dict:
    return _FSDP_DIMS_MOE if moe else _FSDP_DIMS_DENSE


def _with_fsdp(dims: Dict, fsdp: bool, name: str, spec: tuple) -> tuple:
    d = dims.get(name)
    if not fsdp or d is None:
        return spec
    parts = list(spec) + [None] * (d + 1 - len(spec))
    parts[d] = "fsdp"
    return tuple(parts)


def stage_param_specs(fsdp: bool = False, moe: bool = False) -> Dict:
    """The spec of each params['stages'] leaf: stage dim over "pp",
    head/ffn dims over "tp" (column-parallel qkv/wi, row-parallel
    out/wo), experts over "ep" for the MoE FFN, and optionally the model
    dim over "fsdp" (gathered per stage — _gather_stage)."""
    dims = _fsdp_dims(moe)
    base = {
        "ln1": ("pp", None, None),
        "qkv": ("pp", None, None, None, "tp", None),
        "out": ("pp", None, "tp", None, None),
        "ln2": ("pp", None, None),
    }
    if moe:
        base.update({
            # experts sharded over ep; the switch FFN is not tp-sharded
            # (tp stays on attention), so expert dims beyond E are fsdp-only
            "router": ("pp", None, None, None),
            "wi": ("pp", None, "ep", None, None),
            "wo": ("pp", None, "ep", None, None),
        })
    else:
        base.update({
            "wi": ("pp", None, None, "tp"),
            "wo": ("pp", None, "tp", None),
        })
    return {k: _with_fsdp(dims, fsdp, k, v) for k, v in base.items()}


def _gather_stage(params: Dict, group, dims: Dict) -> Dict:
    """FSDP over the stage leaves: each fsdp-sharded leaf gathered whole
    over `group` along its dim (stacked coordinates: the stage dim is
    still there); the backward sums the members' gradients into each
    shard (comm.gather_param)."""
    return {name: leaf if dims.get(name) is None
            else comm.gather_param(leaf, group, dims[name])
            for name, leaf in params.items()}


def param_shardings(params: Dict, mesh: Mesh,
                    fsdp: Optional[bool] = None) -> Dict:
    """The spec tree of the whole param tree on `mesh` (JAX's
    NamedSharding tree; parallel/pp.place cuts each rank's blocks by
    it).  fsdp defaults to mesh['fsdp'] > 1."""
    if fsdp is None:
        fsdp = mesh.shape.get("fsdp", 1) > 1
    moe = "router" in params["stages"]
    return {"embed": {k: () for k in params["embed"]},
            "stages": stage_param_specs(fsdp=fsdp, moe=moe),
            "ln_f": ()}


# ---------------------------------------------------------------- compute
def _layernorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mu).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + 1e-6) * scale
    return y.to(x.dtype)


def _moe_ffn(p: Dict, h: torch.Tensor, *, ep_group,
             capacity_factor: float, n_blocks: int = 1):
    """Switch FFN on the token block h [b, s, e]: with `ep_group` this
    rank's data member's tokens through parallel/ep._local_moe's
    all-to-all dispatch; without, the dense oracle (parallel/ep
    .dense_reference_moe) of the same routing and capacity, over each
    of `n_blocks` row blocks apart (one process standing for the data
    members).  Capacity comes from a block's tokens.  Returns (y, aux),
    aux the blocks' mean."""
    b, s, e = h.shape
    n_experts = p["router"].shape[-1]
    # router math in f32 for a stable softmax
    logits = torch.einsum("bse,ef->bsf", h.to(torch.float32), p["router"])
    wi, wo = p["wi"].to(h.dtype), p["wo"].to(h.dtype)
    if ep_group is not None:
        capacity = max(1, math.ceil(b * s / n_experts * capacity_factor))
        y, aux = _local_moe(
            h.reshape(b * s, e), logits.reshape(b * s, n_experts), wi, wo,
            torch.ones((b * s,), dtype=torch.bool, device=h.device),
            n_experts=n_experts, capacity=capacity, group=ep_group,
            with_aux=True)
        return y.reshape(b, s, e), aux
    w = b // n_blocks
    capacity = max(1, math.ceil(w * s / n_experts * capacity_factor))
    ys, auxes = [], []
    for j in range(n_blocks):
        y, aux = dense_reference_moe(h[j * w:(j + 1) * w],
                                     logits[j * w:(j + 1) * w], wi, wo,
                                     capacity)
        ys.append(y)
        auxes.append(aux)
    return torch.cat(ys), sum(auxes[1:], auxes[0]) / n_blocks


def _block(p: Dict, x: torch.Tensor, *, causal: bool, tp=None,
           ep_group=None, capacity_factor: float = 1.25, n_blocks: int = 1):
    """One transformer block on (possibly tp-local) param shards.
    x: [b, s, e], the same on every tp rank; qkv/out hold h/tp local
    heads and wi/wo f/tp local ffn columns; each residual branch of a tp
    region ends in Tp.exit.  Returns (x, aux) — aux the MoE load-balance
    scalar (0 for dense)."""
    dtype = x.dtype
    h = _layernorm(x, p["ln1"])
    if tp is not None:
        h = tp.enter(h)
    qkv = torch.einsum("bse,ethd->tbshd", h, p["qkv"].to(dtype))
    a = dot_product_attention(qkv[0], qkv[1], qkv[2], causal)
    o = torch.einsum("bshd,hde->bse", a, p["out"].to(dtype))
    if tp is not None:
        o = tp.exit(o)
    x = x + o
    h = _layernorm(x, p["ln2"])
    if "router" in p:
        o, aux = _moe_ffn(p, h, ep_group=ep_group,
                          capacity_factor=capacity_factor, n_blocks=n_blocks)
        # experts are ep-sharded, not tp-sharded: every tp rank computes
        # the whole o alike
        return x + o, aux
    if tp is not None:
        h = tp.enter(h)
    h = gelu(torch.einsum("bse,ef->bsf", h, p["wi"].to(dtype)))
    o = torch.einsum("bsf,fe->bse", h, p["wo"].to(dtype))
    if tp is not None:
        o = tp.exit(o)
    return x + o, torch.zeros((), dtype=torch.float32, device=x.device)


def _stage_fn(p: Dict, x: torch.Tensor, *, causal: bool, tp=None,
              ep_group=None, capacity_factor: float = 1.25,
              with_aux: bool = False, n_blocks: int = 1):
    """One pipeline stage = blocks_per_stage blocks applied in order.
    Leaves of p are [blocks_per_stage, ...] (stage dim already stripped
    by gpipe).  with_aux: return (x, aux summed over the stage's
    blocks)."""
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(p["ln1"].shape[0]):
        x, aux = _block({k: v[i] for k, v in p.items()}, x, causal=causal,
                        tp=tp, ep_group=ep_group,
                        capacity_factor=capacity_factor, n_blocks=n_blocks)
        aux_sum = aux_sum + aux
    if with_aux:
        return x, aux_sum
    return x


def _embed(p: Dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    x = p["embedding"][tokens.long()]
    return (x + p["pos"][None, :tokens.shape[1]]).to(dtype)


def _head(params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = _layernorm(x, params["ln_f"]).to(torch.float32)
    return torch.einsum("bse,ve->bsv", x, params["embed"]["embedding"])


# the products' weights, cast to cfg.dtype once an apply
_MATMUL = ("qkv", "out", "wi", "wo")


def _cast(stages: Dict, dtype, names=_MATMUL) -> Dict:
    return {k: v.to(dtype) if k in names else v for k, v in stages.items()}


def tp_of(mesh: Mesh) -> Optional[comm.Tp]:
    """The mesh's tp group as the stage blocks use it (None at tp 1 or
    outside a job: one process holds every head)."""
    n = mesh.shape["tp"]
    if n == 1 or not mesh.in_job:
        return None
    return comm.Tp(mesh.group("tp"), mesh.coords()["tp"], n)


def make_pipelined_apply(cfg: TransformerConfig, mesh: Mesh, n_micro: int,
                         capacity_factor: Optional[float] = None):
    """f(params, tokens) -> logits running the block stack through the
    gpipe schedule over mesh axis "pp", with tp collectives inside stages
    and the batch over ("dp", "fsdp").  Differentiable end to end.  In a
    job `params` are this rank's blocks (parallel/pp.place over
    `param_shardings`) and `tokens` its data member's rows
    (parallel/pp.data_rows over f.batch_axes); in one process the whole
    tree and the global batch.

    MoE configs (cfg.n_experts > 0): the batch also splits over "ep",
    experts shard over "ep", each stage runs the all-to-all dispatch,
    and f returns (logits, aux) — aux is the load-balance loss summed
    over blocks, averaged over microbatches (comparable to the
    sequential reference's per-batch sum over blocks)."""
    _check_supported(cfg)
    moe = cfg.n_experts > 0
    if moe and capacity_factor is None:
        # capacity derives from LOCAL token counts, so the witness pair
        # (pipelined vs sequential_apply) must be handed the same factor
        # explicitly — a silent default would let the two sides disagree
        # on drop behavior
        raise ValueError(
            "MoE pipeline requires an explicit capacity_factor (pass the "
            "same value to sequential_apply when comparing)")
    if capacity_factor is None:
        capacity_factor = 1.25
    tp = mesh.shape.get("tp", 1)
    ep = mesh.shape.get("ep", 1)
    fsdp = mesh.shape.get("fsdp", 1) > 1
    ep_axis = "ep" if (moe and ep > 1) else None
    if cfg.n_heads % tp:
        raise ValueError(f"tp {tp} must divide n_heads {cfg.n_heads}")
    if not moe and cfg.d_ff % tp:
        raise ValueError(f"tp {tp} must divide d_ff {cfg.d_ff}")
    if moe and cfg.n_experts % ep:
        raise ValueError(f"ep {ep} must divide n_experts {cfg.n_experts}")
    if fsdp and cfg.d_model % mesh.shape["fsdp"]:
        raise ValueError(
            f"fsdp {mesh.shape['fsdp']} must divide d_model {cfg.d_model}")
    batch_axes = ("dp", "fsdp", "ep") if ep_axis else ("dp", "fsdp")
    ep_group = mesh.group("ep") if ep_axis and mesh.in_job else None
    fsdp_group = mesh.group("fsdp") if fsdp and mesh.in_job else None
    stage_fn = functools.partial(
        _stage_fn, causal=cfg.causal, tp=tp_of(mesh), ep_group=ep_group,
        capacity_factor=capacity_factor, with_aux=moe,
        n_blocks=1 if mesh.in_job else mesh.axis_size(batch_axes))
    run = pp.make_pipeline_fn(
        mesh, stage_fn, n_micro, axis_name="pp",
        param_specs=stage_param_specs(fsdp=fsdp, moe=moe),
        batch_axes=batch_axes, has_aux=moe)

    def apply(params: Dict, tokens: torch.Tensor):
        x = _embed(params["embed"], tokens, cfg.dtype)
        stages = params["stages"]
        if fsdp_group is not None:
            stages = _gather_stage(stages, fsdp_group, _fsdp_dims(moe))
        stages = _cast(stages, cfg.dtype)
        if moe:
            x, aux = run(stages, x)
            # gpipe aux = sum over stages × microbatches; per-batch scale
            # (the transformer.py convention: sum over blocks) = / n_micro
            return _head(params, x), aux / n_micro
        return _head(params, run(stages, x))

    apply.batch_axes = batch_axes
    return apply


def sequential_apply(cfg: TransformerConfig, params: Dict,
                     tokens: torch.Tensor,
                     capacity_factor: Optional[float] = None):
    """Unsharded reference: the same params applied block by block in one
    process — the numeric witness for the pipelined path.  MoE configs
    return (logits, aux) like the pipelined apply and require the same
    explicit capacity_factor the pipelined side was built with."""
    if "router" in params["stages"] and capacity_factor is None:
        raise ValueError(
            "MoE reference requires the capacity_factor the pipelined "
            "apply was built with")
    if capacity_factor is None:
        capacity_factor = 1.25
    x = _embed(params["embed"], tokens, cfg.dtype)
    stages = params["stages"]
    moe = "router" in stages
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(stages["ln1"].shape[0]):
        out = _stage_fn({k: v[s] for k, v in stages.items()}, x,
                        causal=cfg.causal, capacity_factor=capacity_factor,
                        with_aux=moe)
        if moe:
            x, aux = out
            aux_sum = aux_sum + aux
        else:
            x = out
    if moe:
        return _head(params, x), aux_sum
    return _head(params, x)


def pipeline_lm_loss(apply_fn, params, tokens) -> torch.Tensor:
    return lm_loss(apply_fn(params, tokens), tokens)


def pipeline_lm_loss_with_aux(apply_fn, params, tokens, aux_weight: float):
    """(total, ce) for MoE pipelines: CE + weighted load-balance aux —
    the same split the train step uses (transformer.lm_train_loss)."""
    logits, aux = apply_fn(params, tokens)
    ce = lm_loss(logits, tokens)
    return ce + aux_weight * aux, ce
