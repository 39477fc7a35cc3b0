"""Pipelined LLaMA LM: the modern-decoder family through the GPipe
schedule (the counterpart of models/pipeline for models/llama).

The port of tf_operator_tpu/models/pipeline_llama.py, on
models/pipeline's design: blocks are plain functions over a dict of
tensors with [n_stages, blocks_per_stage, ...] stacked stage leaves
running under parallel/pp's schedule, with Megatron-style tensor
parallelism inside each stage — wq/wkv column-parallel over "tp" (whole
query/kv heads per shard, so GQA grouping survives: tp must divide
n_kv_heads), attention out and SwiGLU wo row-parallel, each region
closed by one `Tp.exit`.  RoPE needs no parameters: each block slices
the angle table (models/llama.rope_table) by its sequence length
(microbatches split the batch dim; every microbatch carries full
sequences from position 0).  Sliding-window attention passes through to
the banded einsum reference (models/transformer.dot_product_attention).

The embedding (tied) and the RMS head run outside the pipeline, as in
models/pipeline.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from tf_operator_tpu_torch.models.llama import (
    LlamaConfig, apply_rope, rope_table)
from tf_operator_tpu_torch.models.pipeline import (  # noqa: F401
    _cast, _normal, _with_fsdp, _gather_stage, tp_of,
    params_from_jax)  # the weights' bridge: models/pipeline's
from tf_operator_tpu_torch.models.transformer import (
    dot_product_attention, lm_loss)
from tf_operator_tpu_torch.parallel import pp
from tf_operator_tpu_torch.parallel.mesh import Mesh

# the products' weights, cast to cfg.dtype once an apply
_MATMUL = ("wq", "wkv", "out", "wi", "wo")


# ---------------------------------------------------------------- params
def init_params(gen: torch.Generator, cfg: LlamaConfig,
                n_stages: int) -> Dict:
    """Param tree drawn from `gen` on its device: stage leaves stacked
    [n_stages, blocks_per_stage, ...]; embed/ln_f flat.  All f32 (cast
    to cfg.dtype at use)."""
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers {cfg.n_layers} not divisible by n_stages {n_stages}")
    _check_supported(cfg)
    lps = cfg.n_layers // n_stages
    e, h, kv, d, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, cfg.d_ff)
    dev = gen.device
    return {
        "embed": {"embedding": _normal(gen, (cfg.vocab_size, e), 0.02)},
        "stages": {
            "rms1": torch.ones((n_stages, lps, e), device=dev),
            "wq": _normal(gen, (n_stages, lps, e, h, d), 1 / math.sqrt(e)),
            "wkv": _normal(gen, (n_stages, lps, e, 2, kv, d),
                           1 / math.sqrt(e)),
            "out": _normal(gen, (n_stages, lps, h, d, e),
                           1 / math.sqrt(h * d)),
            "rms2": torch.ones((n_stages, lps, e), device=dev),
            # SwiGLU gate+up as [E, 2, F]: the tp shard slices F, keeping
            # a full (gate, up) pair per shard so silu*up needs no
            # collective
            "wi": _normal(gen, (n_stages, lps, e, 2, f), 1 / math.sqrt(e)),
            "wo": _normal(gen, (n_stages, lps, f, e), 1 / math.sqrt(f)),
        },
        "ln_f": torch.ones((e,), device=dev),
    }


def _check_supported(cfg: LlamaConfig) -> None:
    """Reject config fields the pipelined model would silently drop."""
    if not cfg.tie_embeddings:
        raise ValueError("pipelined llama supports tied embeddings only")
    unsupported = {
        "attention_fn": cfg.attention_fn,
        "moe_dispatch_fn": cfg.moe_dispatch_fn,
        "remat": cfg.remat,
        "n_experts": cfg.n_experts,
    }
    set_fields = [k for k, v in unsupported.items() if v]
    if set_fields:
        raise ValueError(
            f"pipelined llama does not support config fields {set_fields}; "
            f"use the non-pipelined Llama (models/llama.py) for "
            f"custom-attention/remat/MoE")


# per stage-leaf: the STACKED-coordinates dim fsdp shards (model dim E).
_FSDP_DIMS = {
    "rms1": None, "wq": 2, "wkv": 2, "out": 4, "rms2": None,
    "wi": 2, "wo": 3,
}


def stage_param_specs(fsdp: bool = False) -> Dict:
    """The spec of each params['stages'] leaf: stage dim over "pp",
    query/kv heads and ffn columns over "tp", optionally E over
    "fsdp"."""
    base = {
        "rms1": ("pp", None, None),
        "wq": ("pp", None, None, "tp", None),
        "wkv": ("pp", None, None, None, "tp", None),
        "out": ("pp", None, "tp", None, None),
        "rms2": ("pp", None, None),
        "wi": ("pp", None, None, None, "tp"),
        "wo": ("pp", None, "tp", None),
    }
    return {k: _with_fsdp(_FSDP_DIMS, fsdp, k, v) for k, v in base.items()}


def param_shardings(params: Dict, mesh: Mesh,
                    fsdp: Optional[bool] = None) -> Dict:
    """The spec tree of the whole param tree on `mesh` (fsdp defaults to
    mesh['fsdp'] > 1)."""
    if fsdp is None:
        fsdp = mesh.shape.get("fsdp", 1) > 1
    return {"embed": {k: () for k in params["embed"]},
            "stages": stage_param_specs(fsdp=fsdp), "ln_f": ()}


# ---------------------------------------------------------------- compute
def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt(torch.square(x32).mean(dim=-1, keepdim=True)
                          + eps)
    return (y * scale).to(x.dtype)


def _block(p: Dict, x: torch.Tensor, *, angles_table: torch.Tensor,
           group: int, tp, window: Optional[int], eps: float
           ) -> torch.Tensor:
    """One llama block on (possibly tp-local) param shards. x: [b, s, e],
    the same on every tp rank; wq/wkv hold whole LOCAL heads (h/tp query,
    kv/tp kv — a contiguous head split keeps each query head's kv head
    on its shard); wi/wo hold f/tp SwiGLU columns.  Each tp region ends
    in Tp.exit."""
    dtype = x.dtype
    angles = angles_table[:x.shape[1]].to(x.device)
    h = _rmsnorm(x, p["rms1"], eps)
    if tp is not None:
        h = tp.enter(h)
    q = torch.einsum("bse,ehd->bshd", h, p["wq"].to(dtype))
    kvp = torch.einsum("bse,eckd->cbskd", h, p["wkv"].to(dtype))
    k, v = kvp[0], kvp[1]
    q = apply_rope(q, angles)
    k = apply_rope(k, angles)
    if group > 1:
        # the reference attention takes kv broadcast to the query heads
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    a = dot_product_attention(q, k, v, True, window=window)
    o = torch.einsum("bshd,hde->bse", a, p["out"].to(dtype))
    if tp is not None:
        o = tp.exit(o)
    x = x + o
    h = _rmsnorm(x, p["rms2"], eps)
    if tp is not None:
        h = tp.enter(h)
    hh = torch.einsum("bse,ecf->bscf", h, p["wi"].to(dtype))
    hh = F.silu(hh[:, :, 0]) * hh[:, :, 1]
    o = torch.einsum("bsf,fe->bse", hh, p["wo"].to(dtype))
    if tp is not None:
        o = tp.exit(o)
    return x + o


def _stage_fn(p: Dict, x: torch.Tensor, *, angles_table, group, tp,
              window, eps) -> torch.Tensor:
    for i in range(p["rms1"].shape[0]):
        x = _block({k: v[i] for k, v in p.items()}, x,
                   angles_table=angles_table, group=group, tp=tp,
                   window=window, eps=eps)
    return x


def _embed(params: Dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["embed"]["embedding"][tokens.long()].to(dtype)


def _head(params: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    x = _rmsnorm(x, params["ln_f"], eps).to(torch.float32)
    return torch.einsum("bse,ve->bsv", x, params["embed"]["embedding"])


def _angles(cfg: LlamaConfig) -> torch.Tensor:
    return rope_table(cfg.max_len, cfg.head_dim, cfg.rope_theta,
                      cfg.rope_scaling)


def make_pipelined_apply(cfg: LlamaConfig, mesh: Mesh, n_micro: int):
    """f(params, tokens) -> logits: llama blocks through the schedule over
    "pp" with tp collectives inside stages and the batch over ("dp",
    "fsdp"); in a job `params` are this rank's blocks and `tokens` its
    data member's rows (models/pipeline.make_pipelined_apply)."""
    _check_supported(cfg)
    tp = mesh.shape.get("tp", 1)
    fsdp = mesh.shape.get("fsdp", 1) > 1
    if cfg.n_heads % tp:
        raise ValueError(f"tp {tp} must divide n_heads {cfg.n_heads}")
    if cfg.n_kv_heads % tp:
        # each shard must own whole kv heads with their whole query group
        raise ValueError(f"tp {tp} must divide n_kv_heads {cfg.n_kv_heads}")
    if cfg.d_ff % tp:
        raise ValueError(f"tp {tp} must divide d_ff {cfg.d_ff}")
    if fsdp and cfg.d_model % mesh.shape["fsdp"]:
        raise ValueError(
            f"fsdp {mesh.shape['fsdp']} must divide d_model {cfg.d_model}")
    fsdp_group = mesh.group("fsdp") if fsdp and mesh.in_job else None
    stage_fn = functools.partial(
        _stage_fn, angles_table=_angles(cfg), group=cfg.q_per_kv,
        tp=tp_of(mesh), window=cfg.sliding_window, eps=cfg.norm_eps)
    run = pp.make_pipeline_fn(
        mesh, stage_fn, n_micro, axis_name="pp",
        param_specs=stage_param_specs(fsdp=fsdp), batch_axes=("dp", "fsdp"))

    def apply(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        x = _embed(params, tokens, cfg.dtype)
        stages = params["stages"]
        if fsdp_group is not None:
            stages = _gather_stage(stages, fsdp_group, _FSDP_DIMS)
        x = run(_cast(stages, cfg.dtype, _MATMUL), x)
        return _head(params, x, cfg.norm_eps)

    apply.batch_axes = ("dp", "fsdp")
    return apply


def sequential_apply(cfg: LlamaConfig, params: Dict,
                     tokens: torch.Tensor) -> torch.Tensor:
    """Unsharded block-by-block reference — the numeric witness."""
    angles_table = _angles(cfg)
    x = _embed(params, tokens, cfg.dtype)
    stages = params["stages"]
    for s in range(stages["rms1"].shape[0]):
        x = _stage_fn({k: v[s] for k, v in stages.items()}, x,
                      angles_table=angles_table, group=cfg.q_per_kv,
                      tp=None, window=cfg.sliding_window, eps=cfg.norm_eps)
    return _head(params, x, cfg.norm_eps)


def pipeline_lm_loss(apply_fn, params, tokens) -> torch.Tensor:
    return lm_loss(apply_fn(params, tokens), tokens)
