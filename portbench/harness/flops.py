"""Operation counts of a Llama-family model, from its shape alone.

Model FLOPs count 2 operations a multiply-add over the products a token
needs: its projections (q, k, v, out; the dense SwiGLU's three, or the
router and the top-k experts' three each), the head where its logits
are needed, and attention's two products over the keys each query sees
(inside the sliding window where there is one).  Training counts the
forward and a backward of twice the forward; recomputation (remat) is
not counted.  The embedding lookup is no product.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

from portbench.harness.weights import Shape


def visible_pairs(start: int, end: int, window: Optional[int]) -> int:
    """(query, key) pairs of the causal queries at positions start..end-1,
    each seeing min(p + 1, window) keys."""
    if end <= start:
        return 0
    if window is None:
        return (end * (end + 1) - start * (start + 1)) // 2
    # positions below window - 1 see p + 1 keys, the rest see window
    cut = min(max(window - 1, start), end)
    low = (cut * (cut + 1) - start * (start + 1)) // 2
    return low + (end - cut) * window


def layer_params(s: Shape) -> Tuple[int, int]:
    """(matmul parameters a token runs through in one layer, of which
    attention's): q, k, v and out, then the dense SwiGLU or the router
    and top_k experts."""
    attn = s.d * s.h * s.hd + 2 * s.d * s.kv * s.hd + s.h * s.hd * s.d
    ffn = (s.top_k * 3 * s.d * s.f + s.d * s.experts) if s.experts \
        else 3 * s.d * s.f
    return attn + ffn, attn


def attention_flops(s: Shape, pairs: int) -> int:
    """The forward's QK^T and PV over `pairs` in every layer."""
    return s.layers * 2 * 2 * s.h * s.hd * pairs


def train_flops(s: Shape, batch: int, seq: int) -> int:
    """One step's model FLOPs: 3 x the forward of `batch` sequences of
    `seq` tokens, the head over the seq - 1 positions with a label."""
    per_layer, _ = layer_params(s)
    fwd = (s.layers * per_layer * 2 * seq + 2 * s.d * s.vocab * (seq - 1)
           + attention_flops(s, visible_pairs(0, seq, s.window)))
    return 3 * batch * fwd


def serve_flops(s: Shape, requests: Iterable[Tuple[int, int]]) -> int:
    """Model FLOPs of serving each (prompt tokens, new tokens) request:
    the body over the prompt and every new token but the last (the
    positions that are fed), the head once per new token."""
    per_layer, _ = layer_params(s)
    total = 0
    for p, n in requests:
        fed = p + n - 1
        total += (s.layers * per_layer * 2 * fed + 2 * s.d * s.vocab * n
                  + attention_flops(s, visible_pairs(0, fed, s.window)))
    return total
