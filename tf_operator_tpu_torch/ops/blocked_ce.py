"""Blocked large-vocab cross-entropy: the lm-head matmul fused into the loss.

The port of tf_operator_tpu/ops/blocked_ce.py.  A decoder LM's loss would
otherwise materialize [N, V] f32 logits (N = B*S tokens; at V = 128256
that is 1 GB per 2k tokens) only to reduce them to one scalar.  Here the
vocab is streamed in chunks with an online logsumexp, so the peak is
[N, chunk].  The backward pass recomputes each chunk's logits and emits
its softmax-weighted gradients chunk by chunk.

The JAX package runs this as a `lax.scan` of XLA matmuls (no Pallas
kernel), so each chunk's product here is a plain torch.matmul; every
product and reduction is f32, as there.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from tf_operator_tpu_torch.models.transformer import MOE_AUX_WEIGHT


def _pick_chunk(v: int, chunk: Optional[int]) -> int:
    """Any chunk works (the tail chunk is padded and masked); the default
    is 8192, or the vocab rounded up to 128 when smaller."""
    if chunk is not None:
        if chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        return min(chunk, v)
    return min(8192, (v + 127) // 128 * 128)


def _chunks(w: torch.Tensor, chunk: int
            ) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
    """(start, [D, chunk] f32 weights, [chunk] valid-column mask) per vocab
    chunk; the tail chunk is zero-padded to the full width."""
    d, v = w.shape
    cols = torch.arange(chunk, device=w.device)
    for start in range(0, v, chunk):
        wc = w[:, start:start + chunk].float()
        if wc.shape[1] < chunk:
            wc = torch.cat([wc, wc.new_zeros(d, chunk - wc.shape[1])], dim=1)
        yield start, wc, (start + cols) < v


class _BlockedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, chunk):
        n = x.shape[0]
        x32 = x.float()
        m = torch.full((n,), -torch.inf, device=x.device)
        s = torch.zeros((n,), device=x.device)
        label_logit = torch.zeros((n,), device=x.device)
        for start, wc, valid in _chunks(w, chunk):
            logits = torch.where(valid, x32 @ wc, -torch.inf)  # [N, chunk]
            m_new = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - m_new) + torch.where(
                valid, torch.exp(logits - m_new[:, None]), 0.0).sum(dim=1)
            m = m_new
            # pick out the label's logit if it falls in this chunk
            local = labels - start
            in_chunk = (local >= 0) & (local < chunk)
            picked = logits.gather(
                1, local.clamp(0, chunk - 1)[:, None])[:, 0]
            label_logit = torch.where(in_chunk, picked, label_logit)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.chunk = chunk
        return (lse - label_logit).mean()

    @staticmethod
    def backward(ctx, g):
        """d loss / d logits = (softmax - onehot(label)) / N, recomputed
        chunk by chunk; dx accumulates, dw is written chunk by chunk."""
        x, w, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk
        n, d = x.shape
        v = w.shape[1]
        x32 = x.float()
        scale = g / n
        dx = torch.zeros((n, d), device=x.device)
        # [V, D] so that the transposed view handed back as dw lands
        # contiguously in a tied embedding's gradient
        dw_t = torch.empty((v, d), device=x.device)
        for start, wc, valid in _chunks(w, chunk):
            logits = x32 @ wc
            p = torch.where(valid, torch.exp(logits - lse[:, None]), 0.0)
            local = labels - start
            in_chunk = (local >= 0) & (local < chunk)
            onehot = torch.zeros_like(p).scatter_(
                1, local.clamp(0, chunk - 1)[:, None], 1.0
            ) * in_chunk[:, None]
            dlogits = (p - onehot) * scale                 # [N, chunk]
            dx = dx + dlogits @ wc.T
            width = min(chunk, v - start)
            dw_t[start:start + width] = (x32.T @ dlogits)[:, :width].T
        return dx.to(x.dtype), dw_t.T.to(w.dtype), None, None


def blocked_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                          labels: torch.Tensor,
                          chunk: Optional[int] = None) -> torch.Tensor:
    """Mean CE of softmax(x @ w) against integer `labels`, without ever
    materializing the [N, V] logits.

    x: [N, D] final-layer activations (flatten [B, S, D] first)
    w: [D, V] lm-head weights (pass `embedding.T` for tied embeddings)
    labels: [N] int targets
    chunk: vocab tile width (default 8192; the tail chunk is padded)."""
    if x.dim() != 2 or w.dim() != 2 or labels.dim() != 1:
        raise ValueError(
            f"expected x[N,D], w[D,V], labels[N]; got {tuple(x.shape)}, "
            f"{tuple(w.shape)}, {tuple(labels.shape)}")
    return _BlockedCE.apply(x, w, labels.to(torch.long),
                            _pick_chunk(w.shape[1], chunk))


def lm_blocked_loss(model, tokens: torch.Tensor,
                    chunk: Optional[int] = None,
                    perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The causal-LM loss of a tied-embedding Llama with the head fused
    into the loss: the body without the logits projection, then the
    blocked CE of hidden[:, :-1] against tokens[:, 1:] over the f32
    embedding matrix.  The port has no MoE blocks yet, so the
    load-balancing aux term the JAX loss adds is 0.

    perm ([S] ids, e.g. ops/zigzag.storage_perm): the model runs on the
    tokens in storage order tokens[:, perm] with positions=perm, and its
    hidden states are put back in logical order before the next-token
    shift, which is taken on the logical `tokens`."""
    cfg = model.cfg
    if not cfg.tie_embeddings:
        raise ValueError("lm_blocked_loss requires tie_embeddings=True")
    if perm is None:
        hidden = model(tokens, return_hidden=True)
    else:
        perm = torch.as_tensor(perm, device=tokens.device).long()
        hidden = model(tokens[:, perm], return_hidden=True, positions=perm)
        hidden = hidden[:, torch.argsort(perm)]
    aux = hidden.new_zeros((), dtype=torch.float32)
    x = hidden[:, :-1].reshape(-1, cfg.d_model)
    labels = tokens[:, 1:].reshape(-1)
    loss = blocked_cross_entropy(x.float(), model.embed.float().T, labels,
                                 chunk)
    return loss + MOE_AUX_WEIGHT * aux
