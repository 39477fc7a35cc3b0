"""What the Llama training path uses of tf_operator_tpu/models/transformer.py:
the einsum attention (the Llama default when no attention_fn is given),
the integer-label causal-LM loss and the MoE aux-loss weight.  The rest of
that file (the BERT/T5 transformer family) waits for ROADMAP Queue 1
item 10.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# Switch Transformer aux-loss weight (paper default 1e-2)
MOE_AUX_WEIGHT = 0.01


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


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token loss for causal LMs over every position (simple CLM):
    integer-label cross-entropy of logits[:, :-1] against tokens[:, 1:],
    averaged."""
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v).float(),
                           tokens[:, 1:].reshape(-1).long())
