"""Switch / top-k expert routing and the single-device MoE FFNs.

The port of the single-device half of tf_operator_tpu/parallel/ep.py:
`topk_route` (first-choice-priority capacity, the `valid` mask of padding
rows, the Switch/Mixtral load-balancing aux loss), `switch_route`,
`_expert_ffn`, `dense_switch_dispatch` (every token through its top-k
experts by one-hot products, capacity = tokens) and
`dense_reference_moe` (the capacity-bounded oracle).  The expert-sharded
all-to-all dispatch (`_local_moe`, `make_switch_moe`) needs an `ep` mesh
axis across cards and is not ported here (ROADMAP Queue 1 item 11).

`grouped_moe` is the port's own form of `dense_switch_dispatch`, which
models/llama.MoeSwiGlu runs: the same function computed sparsely.  The
tokens are grouped by the expert each of their top-k choices names, and
each expert that has tokens runs one product over its rows, whose
outputs are added back with the gates (`index_add_`).  The JAX package
computes every expert for every token (or, at a single-token decode
step, gathers per-token copies of the chosen experts' weights); neither
shape is carried over.  Expert weights may be int8 (models/quant.QTensor):
only the experts a call routes to are dequantized, and since the
dequantization is elementwise with a per-expert scale, gathering before
it gives the same bits as dequantizing the whole tensor.

Ties: `jax.lax.top_k` takes the lower index among equal values and
`torch.topk` promises no order, so every top-k here is a stable
descending sort (`_topk`), which keeps the lower index first.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from tf_operator_tpu_torch.models.quant import QTensor
from tf_operator_tpu_torch.parallel import dp


def _topk(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last axis and their indices, the
    lower index first among equal values (jax.lax.top_k's order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_gates(probs: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates, expert ids) of the top-k router probabilities: k=1 keeps
    the raw argmax probability (the Switch gate); k>1 renormalizes over
    the selected experts, by max(sum, 1e-9) (the Mixtral convention)."""
    top_p, top_i = _topk(probs, k)
    if k > 1:
        return top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9), \
            top_i
    return top_p, top_i


def topk_route(router_logits: torch.Tensor, capacity: int, k: int = 1,
               valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing with per-expert capacity.

    router_logits [T, E] (f32); valid: optional [T] bool, False rows are
    padding (no capacity, no route, excluded from the aux statistics).
    Returns (dispatch [T, E, C] 0/1, combine [T, E, C] gate weights, aux
    scalar).  Capacity is first-choice priority: every token's first
    choice is placed before any second choice, so congestion drops the
    weaker assignments first; a choice over capacity is dropped."""
    t, n_e = router_logits.shape
    dt = router_logits.dtype
    probs = torch.softmax(router_logits, dim=-1)
    gates, top_i = topk_gates(probs, k)
    onehots = F.one_hot(top_i, n_e)                          # [T, k, E] long
    if valid is not None:
        onehots = onehots * valid[:, None, None].to(onehots.dtype)
    dispatch = router_logits.new_zeros((t, n_e, capacity))
    combine = router_logits.new_zeros((t, n_e, capacity))
    claimed = torch.zeros(n_e, dtype=torch.long, device=router_logits.device)
    for c in range(k):
        oh = onehots[:, c]                                   # [T, E]
        pos = torch.cumsum(oh, dim=0) * oh - 1 + claimed[None, :]
        in_cap = (pos >= claimed[None, :]) & (pos < capacity) & (oh > 0)
        slot = F.one_hot(torch.where(in_cap, pos, capacity),
                         capacity + 1).to(dt)[..., :capacity]
        slot = slot * in_cap[..., None].to(dt)
        dispatch = dispatch + slot
        combine = combine + slot * gates[:, c, None, None]
        claimed = claimed + oh.sum(dim=0)
    if valid is None:
        denom = torch.tensor(float(t), device=router_logits.device)
        probs_v = probs
    else:
        denom = torch.clamp(valid.sum().to(torch.float32), min=1.0)
        probs_v = probs * valid[:, None].to(probs.dtype)
    density = onehots.to(torch.float32).sum(dim=(0, 1)) / (denom * k)
    router_mean = probs_v.sum(dim=0) / denom
    aux = n_e * torch.sum(density * router_mean)
    return dispatch, combine, aux


def switch_route(router_logits: torch.Tensor, capacity: int,
                 valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-1 routing with per-expert capacity: (dispatch, the per-token
    gate, aux), topk_route(k=1) with the gate folded out."""
    dispatch, combine, aux = topk_route(router_logits, capacity, 1, valid)
    return dispatch, combine.sum(dim=(1, 2)), aux


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(x) (the tanh approximation, flax's nn.gelu) in x's
    dtype, op for op as JAX writes it: x · 0.5·(1 + tanh(sqrt(2/π)·(x +
    0.044715·x³))), each step rounded to the dtype (F.gelu rounds once,
    from f32)."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=torch.float32).to(
        x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x ** 3))))
    return x * cdf


def _expert_ffn(h: torch.Tensor, act: str) -> torch.Tensor:
    """The nonlinearity after wi: 'swiglu' splits the packed gate and up
    halves of the last axis (silu(gate) * up); 'gelu' is jax.nn.gelu's
    default, the tanh approximation."""
    if act == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        return F.silu(gate) * up
    return gelu(h)


def _aux(probs: torch.Tensor, counts: torch.Tensor, k: int) -> torch.Tensor:
    """The Switch/Mixtral load-balancing loss: n_experts x the dot of
    each expert's share of the top-k selections and its mean router
    probability.  probs [T, E]; counts [E] selections an expert.

    Under data parallelism (parallel/dp.active()) both span every rank's
    tokens, as JAX's jit over the global batch takes them: the counts and
    the probabilities' sums are summed over the ranks.  The value is the
    global loss on every rank; its gradient reaches this rank's probs
    scaled so that the mean of the ranks' gradients is the global one."""
    group = dp.active()
    local = probs.sum(dim=0)
    sums = torch.cat([counts.to(torch.float32), local.detach(),
                      local.new_full((1,), probs.shape[0])])
    if group is not None:
        dp.all_reduce_(sums, group)
    n_e = probs.shape[-1]
    counts_g, sum_g, tokens = sums[:n_e], sums[n_e:2 * n_e], sums[-1]
    # the global mean's value; this rank's share of its gradient
    mine = local * dp.size(group) / tokens
    mean = mine + (sum_g / tokens - mine).detach()
    return n_e * torch.sum(counts_g / (tokens * k) * mean)


def route_aux(router_logits: torch.Tensor, top_k: int = 1) -> torch.Tensor:
    """The load-balancing loss of a routing alone (what grouped_moe and
    dense_switch_dispatch return beside their outputs): the f32 softmax,
    the top-k selections' counts, then _aux.  A tensor-parallel MoE
    block takes it here, outside its parallel region."""
    n_e = router_logits.shape[-1]
    probs = torch.softmax(router_logits.reshape(-1, n_e), dim=-1)
    _, top_i = topk_gates(probs, top_k)
    counts = torch.bincount(top_i.reshape(-1), minlength=n_e)
    return _aux(probs, counts, top_k)


def dense_switch_dispatch(x: torch.Tensor, router_logits: torch.Tensor,
                          wi: torch.Tensor, wo: torch.Tensor,
                          activation: str = "gelu",
                          dtype: Optional[torch.dtype] = None,
                          top_k: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense masked top-k dispatch: every token through every expert,
    weighted by its gates (zero for experts it did not choose); capacity
    = tokens, nothing drops.  x [B, S, D], router_logits [B, S, E] f32,
    wi [E, D, F'], wo [E, F, D].  Returns (y [B, S, D], aux)."""
    dt = dtype or x.dtype
    n_e = wi.shape[0]
    probs = torch.softmax(router_logits, dim=-1)             # [B, S, E]
    gates, top_i = topk_gates(probs, top_k)                  # [B, S, k]
    onehots = F.one_hot(top_i, n_e).to(torch.float32)        # [B, S, k, E]
    combine = torch.einsum("bske,bsk->bse", onehots, gates).to(dt)
    h = _expert_ffn(torch.einsum("bsd,edf->bsef", x, wi), activation)
    out = torch.einsum("bsef,efd->bsed", h, wo)
    out = torch.einsum("bsed,bse->bsd", out, combine)
    counts = onehots.sum(dim=(0, 1, 2))
    return out, _aux(probs.reshape(-1, n_e), counts, top_k)


def dense_reference_moe(x: torch.Tensor, router_logits: torch.Tensor,
                        wi: torch.Tensor, wo: torch.Tensor, capacity: int,
                        activation: str = "gelu", top_k: int = 1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device reference with topk_route's capacity semantics: the
    tokens bucketed [E, C, D], each expert's FFN over its bucket, the
    outputs combined back by the gates."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    dispatch, combine, aux = topk_route(
        router_logits.reshape(b * s, -1).to(torch.float32), capacity, top_k)
    buckets = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), xf)
    h = _expert_ffn(torch.einsum("ecd,edf->ecf", buckets, wi), activation)
    out = torch.einsum("ecf,efd->ecd", h, wo)
    y = torch.einsum("tec,ecd->td", combine.to(x.dtype), out)
    return y.reshape(b, s, d), aux


Weight = Union[torch.Tensor, QTensor]


def _expert(w: Weight, e: int, dtype: torch.dtype) -> torch.Tensor:
    """Expert e's matrix in `dtype`: a slice cast, or an int8 slice and
    its scales dequantized (QTensor.dequantize's bits)."""
    if isinstance(w, QTensor):
        return QTensor(w.q[e], w.scale[e]).dequantize(dtype)
    return w[e].to(dtype)


def grouped_moe(x: torch.Tensor, router_logits: torch.Tensor, wi: Weight,
                wo: Weight, top_k: int = 1, activation: str = "swiglu",
                dtype: Optional[torch.dtype] = None, with_aux: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """dense_switch_dispatch's function, computed sparsely.

    x [..., D]; router_logits [..., E] f32; wi [E, D, F'] and wo [E, F, D]
    as tensors or int8 QTensors.  Softmax in f32, top-k over the
    probabilities (ties to the lower index), the gates renormalized when
    k > 1 and rounded to `dtype` as JAX rounds them.  The (token, choice)
    pairs are sorted by expert; each expert with rows runs its FFN in
    `dtype` over them, and the outputs times their gates are summed per
    token in f32, then rounded to `dtype`.  The per-expert row counts
    are read on the host (one sync a call), so an expert nobody chose
    costs nothing, not even its dequantization.  Returns (y [..., D],
    aux or None when with_aux is False)."""
    dt = dtype or x.dtype
    d = x.shape[-1]
    n_e = router_logits.shape[-1]
    xf = x.reshape(-1, d)
    probs = torch.softmax(router_logits.reshape(-1, n_e), dim=-1)
    gates, top_i = topk_gates(probs, top_k)                  # [T, k]
    flat_e = top_i.reshape(-1)
    counts = torch.bincount(flat_e, minlength=n_e)
    order = torch.argsort(flat_e, stable=True)               # by expert
    gate_of = gates.to(dt).reshape(-1)
    y = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(counts.tolist()):
        if n == 0:
            continue
        pick = order[start:start + n]
        start += n
        rows = pick // top_k
        h = _expert_ffn(xf[rows].to(dt) @ _expert(wi, e, dt), activation)
        out = h @ _expert(wo, e, dt)
        y.index_add_(0, rows, out.float() * gate_of[pick].float()[:, None])
    aux = _aux(probs, counts, top_k) if with_aux else None
    return y.to(dt).reshape(x.shape), aux
