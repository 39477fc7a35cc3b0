"""Switch / top-k expert routing, the single-device MoE FFNs and the
expert-parallel all-to-all dispatch.

The port of tf_operator_tpu/parallel/ep.py: `topk_route`
(first-choice-priority capacity, the `valid` mask of padding rows, the
Switch/Mixtral load-balancing aux loss), `switch_route`, `_expert_ffn`,
`dense_switch_dispatch` (every token through its top-k experts by
one-hot products, capacity = tokens), `dense_reference_moe` (the
capacity-bounded oracle), and `make_switch_moe`, the all-to-all dispatch
over the `ep` mesh axis (`_local_moe` is each ep member's body): the
tokens bucketed [E, C, d] by expert at a fixed capacity, one all-to-all
to the members owning the experts, their FFNs, one all-to-all back, and
the combine.  A choice over capacity is dropped; its output is zero, so
the residual stream carries the token unchanged.

JAX's shard_map splits the GLOBAL flattened token list into contiguous
ep blocks (the batch is not sharded over ep: DEFAULT_RULES puts it on
dcn, dp and fsdp only), so the capacity comes from the global token
count and every dp and tp coordinate computes the same dispatch.  A
rank of the port holds either the global batch (a forward outside a
training step: generate's prefill over a replicated cache, an eval
forward) or its data member's block of it: inside a step over the data
axes (parallel/dp.replicas, the placed training step) and where the
model decodes the rows of a cache split over them (models/llama's
`_data_rows`), which is what parallel/dp.active() tells the dispatch.
A member's block is first gathered with every member's rows
(parallel/comm.gather_param: its backward sums the members' gradients,
each member going on to its own loss); the global batch is taken as it
is.  Each rank takes its ep block of the tokens (comm.take_chunk), and
after the return trip gathers every block's output over ep
(comm.gather_out, the rank's slice backward: every ep member computes
the same loss from it), keeping its member's rows where it held a
block.  The expert gradients are then this rank's share of the data
members' mean (placement.reduce_gradients_ averages them over the batch
axes, never over ep).  Under tensor parallelism the dispatch is one
parallel region: the experts' F columns are the rank's, their partial
outputs sum over tp at the end (Tp.exit), and the aux loss is taken
from the router logits outside the region.

`grouped_moe` is the port's own form of `dense_switch_dispatch`, which
models/llama.MoeSwiGlu runs without a dispatch function: the same
function computed sparsely.  The tokens are grouped by the expert each
of their top-k choices names, and each expert that has tokens runs one
product over its rows, whose outputs are added back with the gates
(`index_add_`).  The JAX package computes every expert for every token
(or, at a single-token decode step, gathers per-token copies of the
chosen experts' weights); neither shape is carried over.  Expert weights
may be int8 (models/quant.QTensor): only the experts a call routes to
are dequantized, and since the dequantization is elementwise with a
per-expert scale, gathering before it gives the same bits as
dequantizing the whole tensor.

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
from tf_operator_tpu_torch.parallel import comm, dp
from tf_operator_tpu_torch.parallel.mesh import BATCH_AXES


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


# ------------------------------------------------- expert parallelism
# (token, choice) pairs make_switch_moe routed on this rank (its ep
# block) and those it dropped at capacity, since the last reset: summed
# on the device without a sync, read by read_stats()
_COUNTS: dict = {}


def reset_stats() -> None:
    _COUNTS.clear()


def read_stats() -> dict:
    """{"calls", "pairs", "dropped"} since the last reset (one sync a
    device)."""
    out = {"calls": 0, "pairs": 0, "dropped": 0}
    for c in _COUNTS.values():
        for key, v in zip(out, c.tolist()):
            out[key] += int(v)
    return out


def _count(valid: torch.Tensor, dispatch: torch.Tensor, top_k: int) -> None:
    pairs = valid.sum() * top_k
    c = torch.stack([torch.ones_like(pairs), pairs,
                     pairs - dispatch.detach().sum().to(pairs.dtype)])
    prev = _COUNTS.get(c.device)
    _COUNTS[c.device] = c if prev is None else prev + c


def _local_moe(x: torch.Tensor, router_logits: torch.Tensor,
               wi: torch.Tensor, wo: torch.Tensor, valid: torch.Tensor, *,
               n_experts: int, capacity: int, group,
               activation: str = "gelu", top_k: int = 1,
               with_aux: bool = False):
    """One ep member's body: x [T, d] its block of the tokens, router
    logits [T, E], wi [E_local, d, f] and wo [E_local, f, d] its experts
    (E_local = E / ep over `group`; every expert where group is None, an
    ep axis of 1), valid [T] the real tokens.  Returns the block's
    output [T, d]; with_aux: (output, aux), JAX's _local_moe's pair for
    a block that is its member's own tokens (models/pipeline): the
    block's topk_route aux, whose value is JAX's psum(aux · n_valid) /
    psum(n_valid) over the group and whose gradient reaches this block's
    logits scaled by ep · n_valid / psum(n_valid) (1 where the blocks
    are equal), so that the mean of the data members' gradients is the
    global one (parallel/pp.reduce_gradients_ takes that mean)."""
    ep = 1 if group is None else torch.distributed.get_world_size(group)
    e_local = n_experts // ep
    dispatch, combine, aux = topk_route(router_logits.to(torch.float32),
                                        capacity, top_k, valid)
    _count(valid, dispatch, top_k)
    dispatch, combine = dispatch.to(x.dtype), combine.to(x.dtype)
    # bucket the block's tokens by expert: [E, C, d]
    buckets = torch.einsum("tec,td->ecd", dispatch, x)
    # all-to-all: bucket block j to the member owning experts j; each
    # member then holds [ep (source), E_local (its own), C, d]
    buckets = buckets.reshape(ep, e_local, capacity, -1)
    buckets = comm.exchange(buckets, group, 0, 0)
    h = _expert_ffn(torch.einsum("secd,edf->secf", buckets, wi), activation)
    out = torch.einsum("secf,efd->secd", h, wo)
    # and back to the members whose tokens they are
    out = comm.exchange(out, group, 0, 0).reshape(n_experts, capacity, -1)
    y = torch.einsum("tec,ecd->td", combine, out)
    if not with_aux or group is None:
        return (y, aux) if with_aux else y
    n_valid = valid.sum().to(torch.float32)
    sums = torch.stack([aux.detach() * n_valid, n_valid])
    comm.all_reduce_(sums, group)
    total = torch.clamp(sums[1], min=1.0)
    mine = aux * (ep * n_valid / total)
    return y, mine + (sums[0] / total - mine).detach()


def ep_aux(router_logits: torch.Tensor, valid: torch.Tensor, ep: int,
           top_k: int) -> torch.Tensor:
    """JAX's aux loss of the ep dispatch: topk_route's aux of each of the
    `ep` contiguous blocks of the [T, E] logits (padding rows excluded),
    weighted by its real tokens, psum(aux * n_valid) / psum(n_valid)."""
    t, n_e = router_logits.shape
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    _, top_i = topk_gates(probs, top_k)
    v = valid.to(torch.float32).reshape(ep, t // ep)
    onehots = F.one_hot(top_i, n_e).to(torch.float32).reshape(
        ep, t // ep, top_k, n_e) * v[:, :, None, None]
    n_valid = v.sum(dim=1)                                   # [ep]
    denom = torch.clamp(n_valid, min=1.0)[:, None]
    density = onehots.sum(dim=(1, 2)) / (denom * top_k)      # [ep, E]
    router_mean = (probs.reshape(ep, t // ep, n_e)
                   * v[:, :, None]).sum(dim=1) / denom
    aux = n_e * torch.sum(density * router_mean, dim=-1)     # [ep]
    return torch.sum(aux * n_valid) / torch.clamp(n_valid.sum(), min=1.0)


def _bank(w, n_experts: int, ep: int, group, dtype):
    """An expert bank in `dtype` as this ep member computes with it: its
    block of experts (the bank placement gave it, or its chunk of a whole
    bank every member holds alike)."""
    if isinstance(w, QTensor):
        w = w.dequantize(dtype)
    w = w.to(dtype)
    if w.shape[0] == n_experts // ep:
        return w
    if w.shape[0] != n_experts:
        raise ValueError(f"an expert bank of {w.shape[0]} experts, where "
                         f"{n_experts} over ep {ep} hold {n_experts // ep} "
                         f"a member")
    return comm.take_chunk(w, group, 0)


def _ranks(group) -> list:
    return ([torch.distributed.get_rank()] if group is None
            else torch.distributed.get_process_group_ranks(group))


def make_switch_moe(mesh, n_experts: int, capacity_factor: float = 1.25,
                    axis_name: str = "ep", activation: str = "gelu",
                    top_k: int = 1):
    """f(x, router_logits, wi, wo, tp=None) -> (y, aux): the all-to-all
    expert-parallel dispatch over `mesh`'s `axis_name` (module
    docstring), JAX's make_switch_moe.

    `mesh` is the job's (make_mesh inside the job); an ep axis of more
    than one member needs its process groups.  x [b, S, d] and
    router_logits [b, S, E] are the global batch, or, inside
    parallel/dp.replicas over the mesh's data axes, this rank's data
    member's block of it; wi [E_local, d, f] / wo [E_local, f, d] its
    experts (placement's ep block, or all E experts, of which each
    member takes its chunk); activation='swiglu' expects wi's last axis
    packed [gate | up].  `tp` (parallel/comm.Tp): the model's
    tensor-parallel group, whose ranks hold the experts' F columns.
    Capacity per (block, expert) = ceil(local_tokens · top_k / E ·
    capacity_factor) over the global token count padded up to the ep
    axis; the padding rows consume no capacity, route nowhere, are
    excluded from the aux statistics and are stripped from y."""
    ep = mesh.shape.get(axis_name, 1)
    if n_experts % ep:
        raise ValueError(f"n_experts {n_experts} not divisible by ep {ep}")
    if not 1 <= top_k <= n_experts:
        raise ValueError(f"top_k {top_k} out of range [1, {n_experts}]")
    ep_group = mesh.group(axis_name)
    if ep > 1 and ep_group is None:
        raise ValueError(f"an expert dispatch over {axis_name} ({ep}) needs "
                         f"the mesh of a job of processes (make_mesh inside "
                         f"the job)")
    data_group = mesh.group(BATCH_AXES)

    def rows_split() -> bool:
        """Whether x is this rank's data member's block (the step's
        group, dp.active(), is the mesh's data axes) or the global
        batch (no group active)."""
        active = dp.active()
        if active is None:
            return False
        if _ranks(active) != _ranks(data_group):
            raise ValueError(
                f"make_switch_moe: the batch is split over ranks "
                f"{_ranks(active)}, where the mesh's data axes "
                f"{BATCH_AXES} hold {_ranks(data_group)}: pass the global "
                f"batch, or a block of it split over exactly the data "
                f"axes (the step of a model placed on this mesh)")
        return True

    def run(x, router_logits, wi, wo, tp=None):
        b, s, d = x.shape
        dt = x.dtype
        split = rows_split()
        member, n_data = ((mesh.axis_index(BATCH_AXES),
                           mesh.axis_size(BATCH_AXES)) if split else (0, 1))
        t = b * s * n_data
        t_pad = -(-t // ep) * ep  # round up to the ep axis
        local_tokens = t_pad // ep
        # top-k tokens claim k slots each: capacity scales with k
        capacity = max(1, math.ceil(
            local_tokens * top_k / n_experts * capacity_factor))
        if tp is not None:
            x = tp.enter(x)
        # the global token list: every data member's rows, or the batch
        # as it came; padded to the ep axis
        rows = data_group if split else None
        xf = comm.gather_param(x, rows, 0).reshape(t, d)
        lf = comm.gather_param(router_logits, rows, 0).reshape(t, -1)
        valid = torch.ones(t_pad, dtype=torch.bool, device=x.device)
        if t_pad != t:
            xf = F.pad(xf, (0, 0, 0, t_pad - t))
            lf = F.pad(lf, (0, 0, 0, t_pad - t))
            valid[t:] = False
        aux = ep_aux(lf, valid, ep, top_k)
        lc = lf if tp is None else tp.enter(lf)
        first = mesh.coords()[axis_name] * local_tokens
        y = _local_moe(
            comm.take_chunk(xf, ep_group, 0),
            comm.take_chunk(lc, ep_group, 0),
            _bank(wi, n_experts, ep, ep_group, dt),
            _bank(wo, n_experts, ep, ep_group, dt),
            valid[first:first + local_tokens], n_experts=n_experts,
            capacity=capacity, group=ep_group, activation=activation,
            top_k=top_k)
        y = comm.gather_out(y, ep_group, 0)
        y = y[:t].reshape(n_data * b, s, d)[member * b:(member + 1) * b]
        return (y if tp is None else tp.exit(y)), aux

    # introspectable routing arity: models/llama checks it against its
    # decode step's moe_top_k
    run.top_k = top_k
    return run
