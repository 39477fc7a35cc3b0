"""Transformer family — BERT-style encoders and decoder LMs (benchmark
ladder configs #4 BERT-large and #5 T5-3B, BASELINE.md), in PyTorch.

The port of tf_operator_tpu/models/transformer.py: `TransformerConfig`
and its factories (`bert_large`, `t5_3b_decoder`, `tiny`), the einsum
attention (`dot_product_attention`, also the Llama default when no
attention_fn is given), `MultiHeadAttention`, `Mlp`, `MoeMlp`, `Block`,
`Transformer`, the losses (`lm_loss`, `lm_train_loss`), the aux-loss
collecting forwards (`apply_with_aux`, `apply_body`) and
`params_flops_per_token`.

Parameter layouts are the flax ones (fused qkv [E, 3, H, D], out
[H, D, E], mlp wi [E, F] and wo [F, E], the experts' raw [X, E, F] wi
and [X, F, E] wo, the router [E, X]), so models/transformer_bridge
carries a flax tree across by renaming.  Every parameter is an f32
master, as flax's `model.init` holds them; numerics follow flax:

  - each projection casts its kernel and input to cfg.dtype
    (DenseGeneral(dtype=...)), the router runs in f32;
  - LayerNorm (no bias, eps 1e-6) takes E[x] and E[x²] in f32, var =
    max(0, E[x²] - E[x]²) (flax's use_fast_variance), (x - mean) ·
    (rsqrt(var + eps) · scale) in f32, cast to cfg.dtype;
  - GELU is jax.nn.gelu's tanh approximation written out as JAX writes
    it, op by op in cfg.dtype (parallel/ep.gelu);
  - the token embedding is gathered in cfg.dtype; the f32 position
    table is cast to cfg.dtype after the gather;
  - the tied logits are flax's Embed.attend, which promotes the hidden
    state and the table to cfg.dtype: a cfg.dtype product, rounded,
    then cast to f32 (the JAX code's `.astype(f32)` on the query is
    undone by that promotion); the untied lm_head is an f32 product.

`cfg.remat` recomputes each block in the backward pass
(torch.utils.checkpoint, non-reentrant); the attention backend then
sees the recomputed forward.  A sparse block's load-balancing loss of
the last forward stays in `MoeMlp.aux_loss` (flax's sow); the losses
here and ops/blocked_ce.lm_blocked_loss add it, weighted.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tf_operator_tpu_torch.parallel import comm
from tf_operator_tpu_torch.parallel.ep import (
    dense_switch_dispatch, gelu, route_aux)

# Switch Transformer aux-loss weight (paper default 1e-2)
MOE_AUX_WEIGHT = 0.01


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32128
    d_model: int = 1024
    n_heads: int = 16
    n_layers: int = 24
    d_ff: int = 4096
    max_len: int = 512
    dtype: torch.dtype = torch.bfloat16
    causal: bool = False  # False: encoder (BERT); True: decoder LM
    tie_embeddings: bool = True
    # attention impl: None -> the einsum reference; or a callable
    # (q, k, v, causal) -> out such as ops/flash_attention.flash_attention
    attention_fn: Optional[Callable] = None
    remat: bool = False  # recompute each block in the backward pass
    # MoE: replace the MLP with a mixture of experts every `moe_every` blocks
    n_experts: int = 0
    moe_every: int = 2
    # expert-parallel all-to-all dispatch (parallel/ep.make_switch_moe);
    # None = the dense masked dispatch
    moe_dispatch_fn: Optional[Callable] = None

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads "
                f"{self.n_heads}")

    def use_moe(self, layer: int) -> bool:
        """Is block `layer` a mixture-of-experts block?"""
        return (self.n_experts > 0
                and layer % self.moe_every == self.moe_every - 1)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _config(base: dict, kw: dict) -> TransformerConfig:
    base.update(kw)  # factory defaults are overridable, never conflicting
    return TransformerConfig(**base)


def bert_large(**kw) -> TransformerConfig:
    return _config(dict(
        vocab_size=30522, d_model=1024, n_heads=16, n_layers=24,
        d_ff=4096, max_len=512, causal=False,
    ), kw)


def t5_3b_decoder(**kw) -> TransformerConfig:
    """Decoder-LM stand-in at T5-3B scale (config #5)."""
    return _config(dict(
        vocab_size=32128, d_model=2048, n_heads=32, n_layers=48,
        d_ff=8192, max_len=512, causal=True,
    ), kw)


def tiny(**kw) -> TransformerConfig:
    return _config(dict(
        vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_len=64,
    ), kw)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """Reference attention path: [B, S, H, D] einsums with equal head
    counts.  As in the JAX package, the scores stay in the input dtype
    (divided by sqrt(D) in that dtype), masked positions take the dtype's
    minimum, the softmax runs in f32 and the probabilities return to the
    input dtype before the PV product.  `window` (causal only): each query
    sees itself plus the window-1 previous positions."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    depth = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(
        math.sqrt(depth), dtype=torch.float32).to(q.dtype)
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        q_ids = torch.arange(s_q, device=q.device)[:, None]
        k_ids = torch.arange(s_k, device=q.device)[None, :]
        mask = q_ids >= k_ids
        if window is not None:
            mask &= k_ids > q_ids - window
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    elif window is not None:
        raise ValueError("window requires causal=True")
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ------------------------------------------------------------------ modules
def _param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=torch.float32))


class LayerNorm(nn.Module):
    """flax nn.LayerNorm(use_bias=False): statistics in f32 by the fast
    variance, the f32 scale folded into the inverse deviation, the
    result cast to `dtype`."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6
                 ) -> None:
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul).to(self.dtype)


class MultiHeadAttention(nn.Module):
    """Fused qkv projection [E, 3, H, D] -> attention -> out [H, D, E],
    every product in cfg.dtype.  Under tensor parallelism
    (parallel/placement) qkv and out hold this rank's heads."""

    tp = None

    def __init__(self, cfg: TransformerConfig) -> None:
        super().__init__()
        self.cfg = cfg
        e, h, d = cfg.d_model, cfg.n_heads, cfg.head_dim
        self.qkv = _param(e, 3, h, d)
        self.out = _param(h, d, e)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        b, s, e = x.shape
        if self.tp is not None:
            x = self.tp.enter(x)
        w = self.qkv.to(dt)
        h, d = w.shape[2], cfg.head_dim
        qkv = (x.to(dt) @ w.view(e, 3 * h * d)).view(b, s, 3, h, d)
        attn = cfg.attention_fn or dot_product_attention
        out = attn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], cfg.causal)
        out = out.reshape(b, s, h * d) @ self.out.to(dt).view(h * d, e)
        return out if self.tp is None else self.tp.exit(out)


class Mlp(nn.Module):
    tp = None  # parallel/placement: wi's columns and wo's rows split

    def __init__(self, cfg: TransformerConfig) -> None:
        super().__init__()
        self.dtype = cfg.dtype
        self.wi = _param(cfg.d_model, cfg.d_ff)
        self.wo = _param(cfg.d_ff, cfg.d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.tp is not None:
            x = self.tp.enter(x)
        h = gelu(x.to(dt) @ self.wi.to(dt))
        out = h @ self.wo.to(dt)
        return out if self.tp is None else self.tp.exit(out)


class MoeMlp(nn.Module):
    """Mixture-of-experts MLP: top-1 switch routing by an f32 router
    over x in f32, every token through the dense masked dispatch
    (parallel/ep.dense_switch_dispatch, GELU experts, capacity = tokens)
    in cfg.dtype, or, where cfg.moe_dispatch_fn is set
    (parallel/ep.make_switch_moe), through that all-to-all dispatch.  The
    load-balancing loss of the last call stays in `aux_loss`.  Under
    tensor parallelism the experts hold this rank's F columns; the
    router and the aux loss stay whole on every rank.  Under expert
    parallelism they hold this rank's experts (ep is then the group the
    dense dispatch gathers them over)."""

    tp = None
    ep = None

    def __init__(self, cfg: TransformerConfig) -> None:
        super().__init__()
        self.dtype = cfg.dtype
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = _param(d, e)
        self.wi = _param(e, d, f)
        self.wo = _param(e, f, d)
        self.dispatch_fn = cfg.moe_dispatch_fn
        self.aux_loss: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        logits = x.float() @ self.router                        # [B, S, X]
        if self.dispatch_fn is not None:
            out, self.aux_loss = self.dispatch_fn(x, logits, self.wi,
                                                  self.wo, tp=self.tp)
            return out
        wi, wo = (comm.gather_out(w.to(dt), self.ep, 0)
                  for w in (self.wi, self.wo))
        if self.tp is not None:
            tp = self.tp
            out, _ = dense_switch_dispatch(
                tp.enter(x), tp.enter(logits), wi, wo, activation="gelu",
                dtype=dt)
            self.aux_loss = route_aux(logits)
            return tp.exit(out)
        out, self.aux_loss = dense_switch_dispatch(
            x, logits, wi, wo, activation="gelu", dtype=dt)
        return out


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, use_moe: bool = False
                 ) -> None:
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg.dtype)
        self.attn = MultiHeadAttention(cfg)
        self.ln2 = LayerNorm(cfg.d_model, cfg.dtype)
        if use_moe:
            self.moe = MoeMlp(cfg)
        else:
            self.mlp = Mlp(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        mlp = self.moe if hasattr(self, "moe") else self.mlp
        return x + mlp(self.ln2(x))


class Transformer(nn.Module):
    """Encoder (BERT-style, causal=False) or decoder LM (causal=True);
    f32 token logits [B, S, V] out, or (return_hidden=True) the final
    LayerNorm's hidden states in cfg.dtype, which ops/blocked_ce fuses
    with the tied head.  `positions` ([S] or [B, S] global ids into the
    position table) follows a permuted token layout (ops/zigzag).

    State-dict names: `embed` [V, E], `pos_embed` [max_len, E],
    `blocks.{i}.{ln1,ln2}.scale`, `blocks.{i}.attn.{qkv,out}`,
    `blocks.{i}.mlp.{wi,wo}` or `blocks.{i}.moe.{router,wi,wo}`,
    `ln_f.scale` and, untied, `lm_head` [E, V].  Under tensor
    parallelism the embedding (and an untied lm_head) hold this rank's
    vocab slice."""

    tp = None  # parallel/placement: the tp group of a sharded model

    def __init__(self, cfg: TransformerConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = _param(cfg.vocab_size, cfg.d_model)
        self.pos_embed = _param(cfg.max_len, cfg.d_model)
        self.blocks = nn.ModuleList(Block(cfg, cfg.use_moe(i))
                                    for i in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype)
        if not cfg.tie_embeddings:
            self.lm_head = _param(cfg.d_model, cfg.vocab_size)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """f32 logits of final-norm hidden states (under tensor
        parallelism, this rank's vocab columns gathered over tp)."""
        dt = self.cfg.dtype
        tied = self.cfg.tie_embeddings
        w = self.embed if tied else self.lm_head
        split = (self.tp is not None
                 and w.shape[0 if tied else 1] != self.cfg.vocab_size)
        if split:
            h = self.tp.enter(h)
        if tied:
            # flax Embed.attend promotes both operands to cfg.dtype
            out = (h.to(dt) @ w.to(dt).t()).float()
        else:
            out = h.float() @ w
        return self.tp.gather_out(out) if split else out

    def forward(self, tokens: torch.Tensor, train: bool = True,
                return_hidden: bool = False,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.dtype
        if positions is None:
            pos = self.pos_embed[None, :tokens.shape[1]]
        else:
            # JAX's gather wraps negative ids once and clamps the rest;
            # torch would fault, so do both explicitly
            idx = positions.to(device=self.pos_embed.device,
                               dtype=torch.long)
            idx = torch.where(idx < 0, idx + cfg.max_len, idx)
            pos = self.pos_embed[idx.clamp(0, cfg.max_len - 1)]
            if pos.dim() == 2:
                pos = pos[None]
        # flax Embed(dtype=...) gathers from the table cast to cfg.dtype:
        # the same bits as casting the gathered rows
        table = self.embed
        if self.tp is not None and table.shape[0] != cfg.vocab_size:
            rows = comm.vocab_parallel_embedding(tokens.to(torch.long), table,
                                                 self.tp)
        else:
            rows = F.embedding(tokens.to(torch.long), table)
        x = rows.to(dt) + pos.to(dt)
        remat = cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                x = torch.utils.checkpoint.checkpoint(blk, x,
                                                      use_reentrant=False)
            else:
                x = blk(x)
        x = self.ln_f(x)
        return x if return_hidden else self.logits(x)


def moe_aux(model: nn.Module) -> torch.Tensor:
    """The sum of the sparse blocks' load-balancing losses of the last
    forward (what flax sows; 0 for a dense model): `blk.moe.aux_loss`
    over `model.blocks`, a Transformer's or a Llama's."""
    aux = torch.zeros((), dtype=torch.float32,
                      device=next(model.parameters()).device)
    for blk in model.blocks:
        if hasattr(blk, "moe"):
            aux = aux + blk.moe.aux_loss
    return aux


def apply_with_aux(model: Transformer, tokens: torch.Tensor,
                   train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass that collects the sparse blocks' load-balancing
    losses: (f32 logits, total aux), aux 0 for dense models."""
    logits = model(tokens, train=train)
    return logits, moe_aux(model)


def apply_body(model: Transformer, tokens: torch.Tensor,
               train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Body-only forward (no logits projection): ([B, S, D] hidden
    states, MoE aux loss), for ops/blocked_ce."""
    hidden = model(tokens, train=train, return_hidden=True)
    return hidden, moe_aux(model)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token loss for causal LMs over every position (simple CLM):
    integer-label cross-entropy of logits[:, :-1] against tokens[:, 1:],
    averaged."""
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v).float(),
                           tokens[:, 1:].reshape(-1).long())


def lm_train_loss(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """CLM loss + weighted MoE load-balancing aux — the loss train steps
    differentiate."""
    logits, aux = apply_with_aux(model, tokens, train=True)
    return lm_loss(logits, tokens) + MOE_AUX_WEIGHT * aux


def params_flops_per_token(cfg: TransformerConfig) -> float:
    """~6 * params FLOPs/token for a train step (fwd+bwd)."""
    p = (
        cfg.vocab_size * cfg.d_model
        + cfg.n_layers
        * (4 * cfg.d_model * cfg.d_model + 2 * cfg.d_model * cfg.d_ff)
    )
    return 6.0 * p
