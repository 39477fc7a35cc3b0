"""The serving loop: the slot scheduler and the continuous scheduler,
over a paged KV pool or dense per-lane rings.

The port of tf_operator_tpu/models/serving.serve_loop.  A fixed
batch of `slots` decode lanes shares one KV block pool; requests wait in
a FIFO queue and stream their prompts straight into their lanes' blocks,
segment by segment (`prefill_chunk`); the last segment's logits give the
first token, and the lane goes live.  Decode steps for all lanes run in
blocks of up to `steps_per_sync`, each lane at its own position, before
the host reads the tokens back.  Frozen lanes (free, pending or finished)
keep stepping with their position pinned and their table row all
scratch, so their writes land in the scratch block.

scheduler="slot" (the oracle): a request is admitted when the pool
covers its whole worst case (prompt + max_new_tokens blocks — the memory
gate, which never lets a smaller request overtake the head); every block
runs `steps_per_sync` steps, a lane that finishes mid-block computes to
the block edge and the host discards the overshoot.
`prefill_chunks_per_sync` bounds the segments a pending prompt streams
per loop turn, with a decode block for the other lanes between.

scheduler="continuous" (the JAX package's iteration scheduler,
`_cb_paged_serve_fns` and its loop):
  - on-device finish: the decode block carries frozen, the budget left
    and eos across its steps, so a lane freezes mid-block; one readback
    per block brings its tokens and live mask;
  - a block runs min(steps_per_sync, longest remaining budget) steps;
  - lazy admission through paging.step_gate (the first segment's blocks
    plus one block per request in flight), coverage grown per segment
    and per block (paging.blocks_to_cover), oldest request first; when
    the pool runs dry the youngest request in flight is preempted back
    to the head of the queue (its blocks freed, its prefill redone on
    re-admission), and admissions hold until a lane finishes;
  - fused dispatch: the oldest pending lane's next segment and the
    decode block for every live lane go to the card together, with no
    host sync between them.  A final segment selects its first token on
    the device and sets that lane's tok/pos for the next block.  When
    nothing is live, prefill streams the slot way.

The host schedule is the JAX package's algorithm step for step under
either scheduler, so a greedy run gives the same tokens AND the same
admitted_at_step, finished_at_step, slot and kv_blocks per request.
Every KV read goes through models/paged_attention: the CUDA kernel on the
card (K1, or K1q for int8 pools), its plain version on the CPU.

int8: `kv_quant=True` makes the pools int8 QTensors (models/quant); a
model built from a quantized state dict serves int8 weights as it is.
`params_transform` takes None or quant.make_dequantizer(cfg.dtype), the
dequantization such a model already applies at each weight's use.

shared_prefix: every request is the prefix followed by its suffix.  The
prefix is prefilled once into refcounted blocks; an admission increfs the
whole-prefix blocks, copies a partial boundary block (copy-on-write,
paging.copy_block) and streams only its suffix.

The disaggregated handoff (models/paging's export/adopt layer):
prefill_only=True serves the prompts under the slot scheduler and, at a
lane's first token, exports its blocks (content hashes in table order
plus payload; a shared prefix's blocks ship once per call) and frees the
lane: the call returns a KVHandoff per request.  adopt=[KVHandoff, ...]
is the decode side: each admission adopts its handoff into this call's
pool (fresh ids, shared blocks deduped by hash through a HandoffRegistry)
and the lane goes live at the handoff's first token, under either
scheduler.  Greedy tokens equal the unified loop's.

Sliding windows (a config with sliding_window, e.g. llama.mistral_7b):
each lane's table is a modular ring of t_blocks slots sized by
llama.auto_cache_len (window plus one chunk's band when prefill_chunk
is set, so a long prompt streams through the ring), and its admission
reserves paging.plan_window_request's blocks, shadows included, under
either scheduler (the continuous one keeps that reservation and admits
no windowed lane lazily).  Before every dispatch whose writes reach a
new block (a prompt segment, a fused segment, a decode block) the lane's
paging.WindowRotation swaps a wrapped-onto shared slot for its shadow,
copying the shared block first while its positions are still in the
window, and drops the reference; the edit reaches the host table (the
pending row or the live one) that the dispatch uploads.  A windowed
export carries the ring's slot map and cursor (`window`: the JAX
package's dict), and the decode side resumes the rotation mid-ring.

Speculation (draft=, spec_k=, draft_transform=): every decode block
becomes rounds of models/speculative.spec_round for every lane at its own
position (spec_k draft steps, one (spec_k+1)-token target verify), up to
spec_k+1 tokens a lane a round.  The draft (a Llama holding its own
weights) has its own pools, routed by the target's table; it writes every
prompt segment and the shared prefix, and a CoW boundary block is copied
in both pools.  Admission reserves the worst case plus spec_k+1 positions
of headroom under either scheduler (no lazy growth, no fused segments:
the continuous scheduler cuts its rounds to the longest remaining
budget).  Greedy tokens equal target-only serving; each ServeResult
counts its accepted and proposed drafts.

Telemetry (models/telemetry.ServeTelemetry): every call feeds one, the
caller's (telemetry=) or a fresh one over the process-global tracer, at
the points where the JAX loop feeds its own; with return_stats the call
returns its ServeStats.  It reads host clocks at barriers the loop
already has and changes no token or schedule.

Dense mode (paged=False, the JAX package's default; the port defaults
to paged=True): each lane owns a ring of cache_len slots per model
(llama.init_cache; a draft's ring is capped at its own max_len), sized
and refused as JAX sizes them.  Admission takes the queue head at once
(there is no memory gate), the prompt streams into a fresh single-row
ring (a copy of the shared prefix's rows when there is one) and the row
is inserted into its lane at the final segment (insert_row), which also
wipes what the lane's frozen steps wrote there.  Decode blocks, the
continuous scheduler's on-device finish and speculation rounds are the
paged ones with no table; nothing fuses.  Every read is llama's
cached_attention, plain PyTorch (JAX reads the dense ring with an XLA
einsum, not a Pallas kernel).  prefill_only and adopt are refused with
JAX's words; block_size and pool_blocks are ignored.

Tensor parallelism (cache_sharding=, draft_cache_sharding=: each a
parallel/tp.kv_cache_sharding(cfg, mesh, slots) of a model placed by
parallel/placement.shard_model): every rank of the job runs the same
call.  Each model's pool takes `_pool_sharding` (this rank's kv heads of
every block; the block ids are host bookkeeping), its dense lanes the
sharding itself (this rank's kv heads and, where slots divide the data
axes, its lanes) and the single-row admission rings `_row_sharding`.
K1/K1q read each rank's pool on its local heads, unchanged: where the
JAX package's Pallas grid owns the kv-head dim that GSPMD shards (so JAX
serves a sharded pool through its gather oracle), each rank here is a
process holding its own heads' pool.  The logits every step selects
from are the same bits on every rank (gathered over tp, and over the
data axes for split lanes), and the ranks' generators are seeded alike,
so the host bookkeeping (tables, the pool's allocator, the registry,
admission, telemetry's counts) runs the same on every rank and every
rank returns the same ServeResults, handoffs and ServeStats counts.
"""
from __future__ import annotations

import dataclasses
import numbers
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models import llama as _llama
from tf_operator_tpu_torch.models import paging, quant
from tf_operator_tpu_torch.models import speculative as _spec
from tf_operator_tpu_torch.models.llama import chunk_fill, chunk_write
from tf_operator_tpu_torch.models.telemetry import ServeTelemetry
from tf_operator_tpu_torch.parallel.tp import (
    KvCacheSharding, check_cache_sharding)


@dataclasses.dataclass
class ServeResult:
    """Per-request outcome: the emitted tokens (EOS included when hit)
    and its schedule — the step its lane went live, the step it
    finished, its lane, and the KV blocks its table referenced.  Under
    speculation, accepted/proposed_drafts count this request's own
    rounds (rounds past its finish excluded)."""

    tokens: List[int]
    admitted_at_step: int
    finished_at_step: int
    slot: int
    accepted_drafts: int = 0
    proposed_drafts: int = 0
    kv_blocks: int = 0


@dataclasses.dataclass
class KVHandoff:
    """One request's prefill -> decode handoff: the first sampled token
    and the lane's exported KV blocks (paging.BlockExport).  Made by
    serve_loop(prefill_only=True), taken by serve_loop(adopt=[...]).
    `completed`: the request finished at its first token (EOS, or a
    budget of 1), so there is no export and the decode side answers it
    without a lane.  prompt_len is the FULL prompt, shared prefix
    included: the decode side is handed the full prompts and checks the
    pairing."""

    rid: int
    prompt_len: int
    budget: int
    first_token: int
    export: Optional[paging.BlockExport] = None
    completed: bool = False
    prefix_len: int = 0


# ------------------------------------------------------------ device steps
def cb_decode_block(model: _llama.Llama, cache, tok: torch.Tensor,
                    pos: torch.Tensor, frozen: torch.Tensor,
                    left: torch.Tensor, eos: int, table: torch.Tensor,
                    n_steps: int, select):
    """The continuous scheduler's block: n_steps single-token decode
    steps for every lane, each at its own position, with the finish on
    the device.  Frozen lanes emit their token unchanged and do not
    advance; a live lane that emits `eos` or spends its budget (`left`)
    freezes inside the block.  Returns (tok, pos, tokens [n_steps, B],
    live [n_steps, B]) on the device; live marks the real tokens."""
    toks, lives = [], []
    for _ in range(n_steps):
        logits = model(tok[:, None], cache, pos, table)
        nxt = torch.where(frozen, tok, select(logits[:, 0]))
        live = ~frozen
        done = live & ((nxt == eos) | (left <= 1))
        pos = torch.where(frozen, pos, pos + 1)
        left = torch.where(frozen, left, left - 1)
        frozen = frozen | done
        tok = nxt
        toks.append(nxt)
        lives.append(live)
    return tok, pos, torch.stack(toks), torch.stack(lives)


def decode_block(model: _llama.Llama, cache, tok: torch.Tensor,
                 pos: torch.Tensor, frozen: torch.Tensor,
                 table: torch.Tensor, n_steps: int, select
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The slot loop's block: n_steps single-token decode steps for every
    lane, each at its own position, no lane finishing inside the block
    (cb_decode_block with no eos and a budget past its edge).  Frozen
    lanes emit their token unchanged and do not advance.  Returns (tok,
    pos, tokens [n_steps, B]) on the device."""
    left = torch.full_like(pos, n_steps + 1)
    tok, pos, toks, _ = cb_decode_block(model, cache, tok, pos, frozen, left,
                                        -1, table, n_steps, select)
    return tok, pos, toks


def insert_row(cache, row_cache, slot: int, sharding=None) -> None:
    """A prefilled single-row dense cache into batch lane `slot` of the
    dense rings, in place (payload and scales of an int8 cache).  Lanes
    split over the data axes (`sharding`): only the rank holding lane
    `slot` writes it, at its local index."""
    if sharding is not None:
        local = cache[0][0].shape[0]
        slot -= sharding.mesh.axis_index(sharding.spec[0]) * local
        if not 0 <= slot < local:
            return
    for (k, v), (rk, rv) in zip(cache, row_cache):
        for leaf, row in ((k, rk), (v, rv)):
            if isinstance(leaf, quant.QTensor):
                leaf.q[slot] = row.q[0]
                leaf.scale[slot] = row.scale[0]
            else:
                leaf[slot] = row[0]


def fused_fill(model: _llama.Llama, cache, tok, pos, frozen, left, eos: int,
               table, segment: torch.Tensor, seg_pos: int,
               seg_table: torch.Tensor, lane: int, n_steps: int, select):
    """One dispatch of a pending lane's FINAL segment and the decode block
    for every live lane.  The segment writes through its own [1, T] table
    (the lane's batch row is still all scratch), so the two touch
    disjoint blocks.  The first token is selected on the device and set,
    with the prompt-end position, into the lane's row for the next
    block.  Returns (tok, pos, tokens, live, first)."""
    seg_logits = chunk_fill(model, cache, segment, seg_pos, seg_table)
    tok, pos, toks, lives = cb_decode_block(model, cache, tok, pos, frozen,
                                            left, eos, table, n_steps,
                                            select)
    first = select(seg_logits)[0]
    tok[lane] = first
    pos[lane] = seg_pos + segment.shape[1]
    return tok, pos, toks, lives, first


def fused_write(model: _llama.Llama, cache, tok, pos, frozen, left,
                eos: int, table, segment: torch.Tensor, seg_pos: int,
                seg_table: torch.Tensor, n_steps: int, select):
    """fused_fill's twin for a non-final segment (no lm_head, no first
    token)."""
    chunk_write(model, cache, segment, seg_pos, seg_table)
    return cb_decode_block(model, cache, tok, pos, frozen, left, eos, table,
                           n_steps, select)


def _readback(toks: torch.Tensor, lives: torch.Tensor,
              first: Optional[torch.Tensor] = None):
    """One device-to-host transfer of a block's tokens [n, B], live mask
    [n, B] and, after a fused fill, the newcomer's first token."""
    n, b = toks.shape
    parts = [toks.reshape(-1), lives.reshape(-1).to(toks.dtype)]
    if first is not None:
        parts.append(first.reshape(1).to(toks.dtype))
    flat = torch.cat(parts).tolist()  # device sync
    rows = [flat[i * b:(i + 1) * b] for i in range(2 * n)]
    return rows[:n], rows[n:], (flat[-1] if first is not None else None)


# ---------------------------------------------------------------- the loop
@dataclasses.dataclass
class _Setup:
    """What _run needs from serve_loop's validation."""

    slots: int
    eos: int
    prefill_chunk: Optional[int]
    chunks_per_sync: Optional[int]
    steps_per_sync: int
    block_size: int
    pool_blocks: int
    t_blocks: int
    # per request (slots needed, shared prefix blocks, private blocks,
    # boundary CoW, shared blocks the ring rotates out; 0 when linear)
    plans: list
    kv_quant: bool
    continuous: bool
    # a sliding-window model: modular tables of t_blocks slots
    windowed: bool
    select: Callable[[torch.Tensor], torch.Tensor]
    dev: torch.device
    # the shared prefix (None without one)
    prefix: Optional[torch.Tensor]
    prefill_only: bool
    # adopt: the handoffs, and each one's export resolved against the
    # union of the batch's payloads (None where completed)
    adopt: Optional[List[KVHandoff]]
    adopt_exports: Optional[List[Optional[paging.BlockExport]]]
    # speculation: the draft (None without), its round width, and the
    # sampling options its rounds draw with
    draft: Optional[_llama.Llama]
    spec_k: int
    sampling: Tuple[float, int, float, Optional[torch.Generator]]
    tel: ServeTelemetry
    # dense mode (paged=False): per-lane rings of eff_len[model] slots,
    # by model name ("target", "draft"); None when paged
    paged: bool = True
    eff_len: Optional[Dict[str, int]] = None
    # tensor parallelism: each model's lane sharding (None: one process)
    sh: Optional[KvCacheSharding] = None
    d_sh: Optional[KvCacheSharding] = None


def serve_loop(model: _llama.Llama, requests: Sequence[Any], *,
               slots: int = 4, max_new_tokens: Union[int, Sequence[int]] = 64,
               eos_id: Optional[int] = None,
               cache_len: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
               generator: Optional[torch.Generator] = None,
               prefill_chunk: Optional[int] = None,
               steps_per_sync: int = 8,
               prefill_chunks_per_sync: Optional[int] = None,
               paged: bool = True, block_size: int = 64,
               pool_blocks: Optional[int] = None,
               scheduler: str = "slot",
               kv_quant: bool = False, params_transform=None,
               return_stats: bool = False,
               device: Union[str, torch.device, None] = None,
               draft: Optional[_llama.Llama] = None, spec_k: int = 4,
               draft_transform=None, shared_prefix=None,
               cache_sharding=None, draft_cache_sharding=None,
               prefill_only: bool = False,
               adopt: Optional[Sequence[KVHandoff]] = None,
               telemetry: Optional[ServeTelemetry] = None):
    """Serve `requests` (1-D token sequences) through `slots` lanes over
    a paged KV pool (or, paged=False, per-lane dense rings); returns a
    ServeResult per request, in request order (with return_stats,
    (results, ServeStats)).

    max_new_tokens: one budget for every request or one per request.
    eos_id: a request that emits it finishes (EOS included in tokens).
    paged: True (the default here; the JAX package defaults to False)
    serves over the block pool; False over dense rings (module
    docstring), where block_size and pool_blocks are ignored, as JAX
    ignores them, and cache_len sizes the rings (default:
    llama.auto_cache_len over the longest prompt and worst case, widened
    by spec_k for a windowed model under speculation).  Greedy tokens
    are the same under either layout.  cache_len is refused when paged.
    temperature / top_k / top_p: 0 = greedy; sampling draws from
    `generator`, a torch.Generator on `device`.
    prefill_chunk: prefill in segments of this many tokens (a multiple
    of block_size); None = one segment per prompt.
    steps_per_sync: decode steps per block between host syncs.
    prefill_chunks_per_sync: at most this many segments of a pending
    prompt per loop turn when prefill streams on its own (needs
    prefill_chunk); None = the whole prompt.
    block_size / pool_blocks: the pool's block size and usable blocks
    (default: every lane can hold the largest worst case at once, the
    shared prefix once — shrink it to engage the memory gate).
    scheduler: "slot" or "continuous" (module docstring).
    kv_quant: int8 KV pools, read through K1q on the card.
    params_transform: None, or quant.make_dequantizer(cfg.dtype).
    device: where the model lives and the loop runs (default "cuda").
    shared_prefix: tokens every request starts with; `requests` are then
    the suffixes (module docstring).
    prefill_only: the prefill side of a handoff (slot scheduler): returns
    a KVHandoff per request (with return_stats, (handoffs, ServeStats)).
    adopt: the decode side: one KVHandoff per request, adopt[i] pairing
    with requests[i], which is the FULL prompt the prefill side served.
    draft / spec_k / draft_transform: speculative serving (module
    docstring); draft is a Llama on the same device, holding its own
    weights, and draft_transform takes None or
    quant.make_dequantizer(draft.cfg.dtype), as params_transform.
    telemetry: the ServeTelemetry to feed (default: a fresh one over the
    process-global tracer).

    cache_sharding / draft_cache_sharding: tensor-parallel serving, one
    parallel/tp.kv_cache_sharding(cfg, mesh, slots) per model (module
    docstring); every rank of the job makes the same call.  A model
    placed over several ranks without one takes kv_cache_sharding with
    the lanes whole."""
    if scheduler not in ("slot", "continuous"):
        raise ValueError(f"scheduler must be 'slot' or 'continuous', got "
                         f"{scheduler!r}")
    continuous = scheduler == "continuous"
    if prefill_only and adopt is not None:
        raise ValueError(
            "prefill_only and adopt are the two ENDS of a handoff — a "
            "call is either the prefill fleet's half or the decode "
            "fleet's half, never both")
    if (prefill_only or adopt is not None) and not paged:
        raise ValueError(
            "disaggregated serving is paged-only: the handoff's wire "
            "format IS the block table (models/paging.BlockExport) — "
            "a dense lane has no blocks to export or adopt; pass "
            "paged=True")
    if (prefill_only or adopt is not None) and draft is not None:
        raise ValueError(
            "speculative serving does not hand off: target and draft "
            "share the block table but ship as TWO pools — drop the "
            "draft or serve unified")
    if prefill_only and continuous:
        raise ValueError(
            "prefill_only rides the slot scheduler's admission/prefill "
            "path (there are no decode lanes to fuse with) — use "
            "scheduler='slot' on the prefill fleet; the DECODE side "
            "takes adopt= under either scheduler")
    if adopt is not None and shared_prefix is not None:
        raise ValueError(
            "adopt= refuses shared_prefix: the prefix's blocks ride "
            "the handoff (content-hash dedup adopts them once) — pass "
            "the FULL prompts the prefill side served")

    cfg = model.cfg
    spec = draft is not None
    _row_sharding(draft_cache_sharding)  # refused even without a draft
    if spec and not isinstance(draft, _llama.Llama):
        raise ValueError(
            f"draft model given without draft_params: the port's draft "
            f"is a Llama holding its own weights, got "
            f"{type(draft).__name__}")
    for name, xf, m in (("params_transform", params_transform, model),
                        ("draft_transform", draft_transform, draft)):
        if m is not None:
            _llama.check_transform(name, xf, m)
    dev = resolve_device(device)
    for name, m in (("model", model), ("draft", draft)):
        if m is not None:
            _llama.check_model_device(name, m, dev)
    lane_sh = _llama.cache_sharding_for("cache_sharding", model,
                                        cache_sharding, slots)
    d_lane_sh = (_llama.cache_sharding_for("draft_cache_sharding", draft,
                                           draft_cache_sharding, slots)
                 if spec else None)
    tel = telemetry if telemetry is not None else ServeTelemetry()
    reqs = [torch.as_tensor(r, dtype=torch.long).reshape(-1).cpu()
            for r in requests]
    if not reqs:
        # zero requests is still a run: the telemetry reports the
        # configured slots and speculation, and completes its lifecycle
        tel.loop_started(0, slots, spec, scheduler=scheduler, device=dev)
        stats = tel.finalize()
        return ([], stats) if return_stats else []
    if isinstance(max_new_tokens, numbers.Integral):
        budgets = [int(max_new_tokens)] * len(reqs)
    else:
        budgets = [int(b) for b in max_new_tokens]
        if len(budgets) != len(reqs):
            raise ValueError(
                f"max_new_tokens sequence has {len(budgets)} entries for "
                f"{len(reqs)} requests — one budget per request")
    for i, b in enumerate(budgets):
        if b < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {b} (request {i})")
    if adopt is not None:
        adopt = list(adopt)
        if len(adopt) != len(reqs):
            raise ValueError(
                f"adopt has {len(adopt)} handoffs for {len(reqs)} "
                f"requests — adopt[i] pairs with requests[i]")
        for i, h in enumerate(adopt):
            if int(h.prompt_len) != int(reqs[i].shape[0]):
                raise ValueError(
                    f"handoff {i}: prompt_len {h.prompt_len} != "
                    f"request length {int(reqs[i].shape[0])} — the "
                    f"decode side takes the FULL prompt the prefill "
                    f"side served (prefix included), in the same order")
            if int(h.budget) != budgets[i]:
                raise ValueError(
                    f"handoff {i}: prefill planned budget {h.budget} "
                    f"but this call asked {budgets[i]} — budgets must "
                    f"match across the handoff or completed-at-prefill "
                    f"decisions diverge")
            if not h.completed and h.export is None:
                raise ValueError(
                    f"handoff {i}: no export and not completed — "
                    f"nothing to adopt")
    if prefill_chunk is not None and prefill_chunk < 1:
        raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
    prefix = (torch.as_tensor(shared_prefix, dtype=torch.long).reshape(-1)
              .cpu() if shared_prefix is not None else None)
    p_fix = 0 if prefix is None else int(prefix.shape[0])
    if prefix is not None:
        if p_fix < 1:
            raise ValueError("shared_prefix must be non-empty when given")
        if prefill_chunk is not None and p_fix % prefill_chunk != 0:
            raise ValueError(
                f"shared_prefix length {p_fix} must be a multiple of "
                f"prefill_chunk {prefill_chunk} so suffix segments stay "
                f"chunk-aligned (pad the prefix or adjust the chunk)")
        for i, r in enumerate(reqs):
            if r.shape[0] < 1:
                raise ValueError(
                    f"request {i} is empty — with a shared_prefix, at "
                    f"least one suffix token is needed to produce the "
                    f"first-token logits")
        # from here on every request IS prefix + suffix
        reqs = [torch.cat([prefix, r]) for r in reqs]
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    if steps_per_sync < 1:
        raise ValueError(f"steps_per_sync must be >= 1, got {steps_per_sync}")
    if prefill_chunks_per_sync is not None:
        if prefill_chunks_per_sync < 1:
            raise ValueError(
                f"prefill_chunks_per_sync must be >= 1 (or None for "
                f"unbounded), got {prefill_chunks_per_sync}")
        if prefill_chunk is None:
            raise ValueError(
                "prefill_chunks_per_sync needs prefill_chunk: an "
                "unchunked prompt prefills in one segment, so the "
                "admission-stall bound cannot apply")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")
    _llama.check_truncation(cfg.vocab_size, top_k, top_p)
    if eos_id is not None and not 0 <= int(eos_id) < cfg.vocab_size:
        raise ValueError(
            f"eos_id {eos_id} out of range for vocab_size {cfg.vocab_size}")
    eos = -1 if eos_id is None else int(eos_id)
    if spec:
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if draft.cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"target vocab {cfg.vocab_size} != draft vocab "
                f"{draft.cfg.vocab_size} — speculation compares token ids")
    # speculation headroom: a verify round writes spec_k+1 positions past
    # a lane's current length
    headroom = (spec_k + 1) if spec else 0
    model_cfgs = [("target", cfg)] + ([("draft", draft.cfg)] if spec else [])
    if paged:
        _check_paged(cfg, model_cfgs, spec, spec_k, block_size,
                     prefill_chunk, cache_len)
    for i, r in enumerate(reqs):
        if r.shape[0] < 1:
            raise ValueError(f"request {i} is empty")
        for name, c in model_cfgs:
            if r.shape[0] + budgets[i] + headroom > c.max_len:
                raise ValueError(
                    f"request {i}: prompt {r.shape[0]} + new {budgets[i]}"
                    + (f" (+{headroom} speculation headroom)" if spec
                       else "")
                    + f" exceeds max_len {c.max_len} ({name})")

    def select(logits: torch.Tensor) -> torch.Tensor:
        return _llama._select_token(logits, temperature, generator, top_k,
                                    top_p)

    setup = _Setup(slots=slots, eos=eos, prefill_chunk=prefill_chunk,
                   chunks_per_sync=prefill_chunks_per_sync,
                   steps_per_sync=steps_per_sync, block_size=block_size,
                   pool_blocks=0, t_blocks=0, plans=[], kv_quant=kv_quant,
                   continuous=continuous,
                   windowed=cfg.sliding_window is not None, select=select,
                   dev=dev, prefix=prefix, prefill_only=prefill_only,
                   adopt=adopt, adopt_exports=None, draft=draft,
                   spec_k=spec_k,
                   sampling=(float(temperature), int(top_k), float(top_p),
                             generator),
                   tel=tel, paged=paged, sh=lane_sh, d_sh=d_lane_sh)
    if paged:
        _size_pool(setup, cfg, reqs, budgets, headroom, pool_blocks)
    else:
        setup.eff_len = _size_rings(reqs, budgets, model_cfgs, spec, spec_k,
                                    headroom, prefill_chunk, cache_len)
    with torch.inference_mode():
        results = _run(model, reqs, budgets, setup)
    # every exit idles the occupancy gauges and samples the memory peak
    tel.loop_finished()
    return (results, tel.finalize()) if return_stats else results


def _row_sharding(sharding: Optional[KvCacheSharding]
                  ) -> Optional[KvCacheSharding]:
    """Single-row admission caches take the lanes' sharding with the
    batch axis unpartitioned (a size-1 dim does not shard).  Anything but
    one KvCacheSharding is refused."""
    if sharding is None:
        return None
    check_cache_sharding("serve_loop cache shardings", sharding)
    return dataclasses.replace(sharding,
                               spec=(None,) + tuple(sharding.spec[1:]))


def _pool_sharding(sharding: Optional[KvCacheSharding]
                   ) -> Optional[KvCacheSharding]:
    """The lanes' sharding ([B, C, KV, D]) projected onto the pool's
    [N+1, bs, KV, D]: the kv-head dim keeps its axis, the block axis and
    in-block positions replicate (block ids are host bookkeeping)."""
    if sharding is None:
        return None
    _row_sharding(sharding)  # one KvCacheSharding, validated
    return dataclasses.replace(sharding,
                               spec=(None, None) + tuple(sharding.spec[2:]))


def _check_paged(cfg, model_cfgs, spec: bool, spec_k: int, block_size: int,
                 prefill_chunk: Optional[int],
                 cache_len: Optional[int]) -> None:
    """The paged-only refusals, with JAX's words."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if spec and any(c.sliding_window is not None for _n, c in model_cfgs):
        w_name, w_cfg = next((n, c) for n, c in model_cfgs
                             if c.sliding_window is not None)
        need = paging.blocks_for(w_cfg.sliding_window + spec_k + 1,
                                 block_size)
        raise ValueError(
            f"paged sliding-window serving does not compose with "
            f"speculation: target and draft share ONE block table, "
            f"but a window table is modular per model — the {w_name}"
            f"'s window {w_cfg.sliding_window} (+ verify headroom "
            f"{spec_k + 1}) needs a private ring of {need} blocks "
            f"of {block_size} tokens whose wrap seam the other "
            f"model's positions would shear — use the dense ring "
            f"(paged=False), which sizes each model's ring "
            f"independently")
    if cache_len is not None:
        raise ValueError(
            "cache_len is a dense-ring knob; paged serving sizes "
            "memory by pool_blocks x block_size — pass pool_blocks "
            "instead")
    if prefill_chunk is not None and prefill_chunk % block_size:
        raise ValueError(
            f"prefill_chunk {prefill_chunk} must be a multiple of "
            f"block_size {block_size} so every streamed segment "
            f"writes whole blocks (adjust the chunk or the block "
            f"size)")


def _size_rings(reqs, budgets, model_cfgs, spec: bool, spec_k: int,
                headroom: int, prefill_chunk: Optional[int],
                cache_len: Optional[int]) -> Dict[str, int]:
    """Dense mode's ring length per model, sized and refused as the JAX
    package sizes them: cache_len defaults to llama.auto_cache_len over
    the longest prompt and the worst case plus headroom, for every model
    (a windowed one's window widened by spec_k under speculation), and
    each model's ring is capped at its own max_len.  A full-causal model
    must hold the worst case; a windowed ring that wraps must hold its
    window (+ spec_k); an unchunked prompt must fit the smallest ring;
    a chunk must divide every ring."""
    longest = max(int(r.shape[0]) for r in reqs)
    worst_i = max(range(len(reqs)),
                  key=lambda i: int(reqs[i].shape[0]) + budgets[i])
    worst_total = int(reqs[worst_i].shape[0]) + budgets[worst_i]
    if cache_len is None:
        cache_len = max(
            _llama.auto_cache_len(
                (dataclasses.replace(c, sliding_window=c.sliding_window
                                     + spec_k)
                 if spec and c.sliding_window is not None else c),
                longest, worst_total + headroom, prefill_chunk)
            for _n, c in model_cfgs)
    eff_len = {name: min(cache_len, c.max_len) for name, c in model_cfgs}
    worst = worst_total + headroom
    for name, c in model_cfgs:
        if c.sliding_window is None and worst > eff_len[name]:
            raise ValueError(
                f"request {worst_i}: prompt {reqs[worst_i].shape[0]}"
                f" + new {budgets[worst_i]} (+{headroom} headroom) "
                f"exceeds cache length {eff_len[name]} — a "
                f"full-causal {name} model cannot stream past its "
                f"cache")
        if c.sliding_window is not None:
            need = min(c.sliding_window + (spec_k if spec else 0), worst)
            if eff_len[name] < need:
                raise ValueError(
                    f"cache_len {eff_len[name]} < {name} requirement "
                    f"{need} (window {c.sliding_window}"
                    + (f" + spec_k {spec_k}" if spec else "")
                    + ", capped at the no-wrap total) — visible "
                    "positions would be overwritten")
    for i, r in enumerate(reqs):
        p_len = int(r.shape[0])
        chunk = (prefill_chunk if prefill_chunk is not None
                 and prefill_chunk < p_len else None)
        if chunk is None and p_len > min(eff_len.values()):
            raise ValueError(
                f"request {i}: prompt {p_len} exceeds cache_len "
                f"{min(eff_len.values())}; pass prefill_chunk to "
                f"stream it")
        if chunk is not None:
            for name, c in model_cfgs:
                _llama.check_prefill_chunk(chunk, eff_len[name],
                                           c.sliding_window,
                                           streams_past_cache=True)
    return eff_len


def _size_pool(o: _Setup, cfg, reqs, budgets, headroom: int,
               pool_blocks: Optional[int]) -> None:
    """Paged mode's block math, into `o`: the table width, each request's
    plan and the pool (refusing a request that cannot fit an empty
    pool), and the handoffs' exports resolved against the batch."""
    prefill_chunk, block_size = o.prefill_chunk, o.block_size
    prefill_only, adopt, spec = o.prefill_only, o.adopt, o.draft is not None
    p_fix = 0 if o.prefix is None else int(o.prefix.shape[0])
    # block math: a linear table covers the largest worst case; a
    # windowed one is a ring of ring_len // block_size slots, sized as
    # the JAX package sizes it (block- and chunk-aligned), whatever the
    # sequence length.  A prefill_only lane plans for its prompt only:
    # the first token comes off the final fill's logits, and decode
    # growth (and its overshoot's wraps) belongs to the decode side
    worst_total = max(int(r.shape[0]) + b for r, b in zip(reqs, budgets))
    windowed = o.windowed
    if windowed:
        window = cfg.sliding_window
        ring_len = _llama.auto_cache_len(
            cfg, max(int(r.shape[0]) for r in reqs), worst_total,
            prefill_chunk)
        if prefill_chunk is None:
            ring_len = -(-ring_len // block_size) * block_size
        t_blocks = ring_len // block_size
        if p_fix > ring_len:
            raise ValueError(
                f"shared_prefix length {p_fix} exceeds the window "
                f"ring ({t_blocks} blocks x {block_size} = "
                f"{ring_len} positions, window {window}) — a prefix "
                f"longer than the ring would wrap over itself; "
                f"shrink the prefix or use the dense ring")
        for i, r in enumerate(reqs):
            p_len = int(r.shape[0])
            chunk = (prefill_chunk if prefill_chunk is not None
                     and prefill_chunk < p_len else None)
            if chunk is None and p_len > ring_len:
                raise ValueError(
                    f"request {i}: prompt {p_len} exceeds the window "
                    f"ring {ring_len}; pass prefill_chunk to stream it")
            if chunk is not None:
                _llama.check_prefill_chunk(
                    chunk, ring_len, window,
                    streams_past_cache=p_len + budgets[i] > ring_len)
        plans = [paging.plan_window_request(
            int(r.shape[0]), 0 if prefill_only else budgets[i], block_size,
            t_blocks, p_fix,
            write_slack=0 if prefill_only else o.steps_per_sync - 1)
            for i, r in enumerate(reqs)]
    else:
        t_blocks = paging.blocks_for(worst_total + headroom, block_size)
        plans = [paging.plan_request(int(r.shape[0]),
                                     0 if prefill_only else budgets[i],
                                     0 if prefill_only else headroom,
                                     block_size, p_fix) + (0,)
                 for i, r in enumerate(reqs)]
    n_prefix_blocks = paging.blocks_for(p_fix, block_size)
    if pool_blocks is None:
        pool_blocks = o.slots * max(pl[2] for pl in plans) + n_prefix_blocks
    if pool_blocks < 1:
        raise ValueError(f"pool_blocks must be >= 1, got {pool_blocks}")
    for i, (r, pl) in enumerate(zip(reqs, plans)):
        # the worst case must fit an EMPTY pool (prefix aside) or the gate
        # waits forever
        if pl[2] + n_prefix_blocks > pool_blocks:
            raise ValueError(
                f"request {i}: prompt {r.shape[0]} + new {budgets[i]}"
                + (f" (+{headroom} speculation headroom)" if spec else "")
                + f" needs {pl[2]} private blocks of {block_size} tokens"
                + (f" (+{n_prefix_blocks} shared prefix blocks)"
                   if p_fix else "")
                + f", but the pool has {pool_blocks} — grow pool_blocks "
                f"or shrink the request")

    o.pool_blocks, o.t_blocks, o.plans = pool_blocks, t_blocks, plans
    if adopt is not None:
        for i, h in enumerate(adopt):
            _check_ring(i, h.export, t_blocks if windowed else None)
        # every export adopts against the UNION of the batch's payloads:
        # a sender elides bytes it shipped under an earlier request's
        # hash, but a preemption here can free that block before a later
        # re-admission needs it
        union: Dict[str, Any] = {}
        for h in adopt:
            if h.export is not None:
                union.update(h.export.payload)
        o.adopt_exports = [
            None if h.export is None else paging.BlockExport(
                h.export.block_size, h.export.hashes, h.export.shared,
                {hh: union[hh] for hh in h.export.hashes if hh in union},
                h.export.window)
            for h in adopt]


def _clone_cache(cache) -> list:
    """A copy of a dense cache (an int8 one's payloads and scales)."""
    def one(t):
        if isinstance(t, quant.QTensor):
            return quant.QTensor(t.q.clone(), t.scale.clone())
        return t.clone()

    return [(one(k), one(v)) for k, v in cache]


def _check_ring(i: int, export: Optional[paging.BlockExport],
                ring: Optional[int]) -> None:
    """An export adopts only into a table of its own kind: a windowed
    one into a ring of the same width (`ring`, the receiver's t_blocks),
    a linear one into a linear table (ring None).  Raised before the
    loop starts, so no pool or registry exists yet."""
    if export is None:
        return
    win = export.window
    if ring is not None and (win is None or win["ring"] != ring):
        raise paging.HandoffError(
            f"windowed adoption needs a matching ring: sender "
            f"shipped {None if win is None else win['ring']}, "
            f"this pool's tables are {ring} wide")
    if ring is None and win is not None:
        raise paging.HandoffError(
            f"handoff {i}: the export carries a sliding-window ring of "
            f"{win['ring']} slots, but this model has no sliding_window "
            f"and its tables are linear")


def _run(model, reqs, budgets, o: _Setup):
    cfg = model.cfg
    dev, slots, eos, select = o.dev, o.slots, o.eos, o.select
    bs = o.block_size
    tel = o.tel
    p_fix = 0 if o.prefix is None else int(o.prefix.shape[0])
    spec = o.draft is not None
    paged = o.paged
    pool_sh = _pool_sharding(o.sh)
    if paged:
        pool = paging.BlockPool(o.pool_blocks, bs)
        cache = paging.init_block_pool(cfg, o.pool_blocks, bs, device=dev,
                                       kv_quant=o.kv_quant,
                                       sharding=pool_sh)
        # the draft's pools: the same block ids through the same tables
        d_cache = (paging.init_block_pool(o.draft.cfg, o.pool_blocks, bs,
                                          device=dev, kv_quant=o.kv_quant,
                                          sharding=_pool_sharding(o.d_sh))
                   if spec else None)
        # block tables live on the host, as the JAX continuous loop keeps
        # them: every edit is a host write, and each dispatch uploads its
        # tables once
        table = torch.zeros((slots, o.t_blocks), dtype=torch.int32)
    else:
        # dense: one ring a lane per model, [slots, eff_len, KV, D]; a
        # prompt prefills into a fresh single-row ring and is inserted
        # into its lane whole at activation, which also wipes whatever
        # the lane's frozen steps wrote there
        pool = table = None
        cache = _llama.init_cache(cfg, slots, o.eff_len["target"],
                                  kv_quant=o.kv_quant, device=dev,
                                  sharding=o.sh)
        d_cache = (_llama.init_cache(o.draft.cfg, slots, o.eff_len["draft"],
                                     kv_quant=o.kv_quant, device=dev,
                                     sharding=o.d_sh)
                   if spec else None)
    tok = torch.zeros((slots,), dtype=torch.long, device=dev)
    pos = torch.zeros((slots,), dtype=torch.int32, device=dev)
    frozen_py = [True] * slots
    owner: List[Optional[int]] = [None] * slots
    emitted: List[List[int]] = [[] for _ in range(slots)]
    results: List[Optional[ServeResult]] = [None] * len(reqs)
    admitted_step = [0] * slots
    # speculation: (accepted, proposed) drafts of each lane's occupant
    spec_acc = [(0, 0)] * slots
    # per-lane blocks: shared (increffed prefix, or adopted dedup-eligible)
    # and own (private, freed plainly)
    lane_shared: List[List[int]] = [[] for _ in range(slots)]
    lane_own: List[List[int]] = [[] for _ in range(slots)]
    lane_nblocks = [0] * slots
    # windowed lanes: each one's ring bookkeeping (slot map, shadows)
    lane_rot: Dict[int, paging.WindowRotation] = {}
    # the continuous scheduler grows linear paged lanes lazily; a
    # windowed lane keeps its ring reservation (the ring is its per-step
    # bound), and a speculative one its worst case (a verify writes
    # ahead)
    lazy = paged and o.continuous and not o.windowed and not spec
    queue = deque(range(len(reqs)))
    pending: Dict[int, dict] = {}
    n_step = 0
    # continuous: admissions wait after a preemption until a lane finishes
    hold = False
    # the handoff: hashes this call already shipped (a shared prefix's
    # blocks go once), the handoffs made, and the receiver's registry,
    # through which every decref of an adopted shared block goes
    sent_hashes: set = set()
    handoffs: List[Optional[KVHandoff]] = [None] * len(reqs)
    registry = (paging.HandoffRegistry(pool) if o.adopt is not None
                else None)

    def effective_chunk(p_len: int) -> Optional[int]:
        # a chunk >= the prompt is a one-segment prefill
        if o.prefill_chunk is not None and o.prefill_chunk < p_len:
            return o.prefill_chunk
        return None

    def resume_index(p_len: int) -> int:
        """Leading segments of a prompt's schedule that the prefix blocks
        already hold (0 without a shared prefix)."""
        if p_fix == 0:
            return 0
        if effective_chunk(p_len) is None:
            return 1
        return p_fix // o.prefill_chunk

    def request_segments(p_len: int):
        """The FULL prompt's segment schedule: an unchunked prompt with a
        shared prefix gets two segments (prefix write, suffix fill) so
        the split point exists."""
        if p_fix and effective_chunk(p_len) is None:
            return [(0, p_fix, False), (p_fix, p_len, True)]
        return _llama.prefill_segments(p_len, o.prefill_chunk)

    def segments_of(ridx: int):
        return request_segments(int(reqs[ridx].shape[0]))

    def fresh_rows() -> dict:
        """Dense mode: one admission's single-row rings ("row", and the
        draft's "d_row"), copies of the shared prefix's when there is
        one, else zeroed."""
        if pfx:
            return {"row": _clone_cache(pfx["row"]),
                    "d_row": _clone_cache(pfx["d_row"]) if spec else None}
        return {"row": _llama.init_cache(cfg, 1, o.eff_len["target"],
                                         kv_quant=o.kv_quant, device=dev,
                                         sharding=_row_sharding(o.sh)),
                "d_row": (_llama.init_cache(o.draft.cfg, 1,
                                            o.eff_len["draft"],
                                            kv_quant=o.kv_quant, device=dev,
                                            sharding=_row_sharding(o.d_sh))
                          if spec else None)}

    def write_segment(piece: torch.Tensor, start: int, st: dict,
                      last: bool):
        """One prompt segment of a pending lane: the target's write (a
        final one returns the last position's logits), then the draft's,
        which only writes.  Paged: into the lane's blocks through its row
        table; dense: into its single-row rings."""
        if paged:
            t_c, d_c, row = cache, d_cache, st["row_tbl"].to(dev)
        else:
            t_c, d_c, row = st["row"], st["d_row"], None
        out = (chunk_fill if last else chunk_write)(model, t_c, piece,
                                                    start, row)
        if spec:
            chunk_write(o.draft, d_c, piece, start, row)
        return out

    def blocks_in_use() -> None:
        if paged:
            tel.blocks_in_use(pool.used)

    def dev_table() -> Optional[torch.Tensor]:
        return table.to(dev) if paged else None

    # the shared prefix is prefilled ONCE: into blocks the pool's base
    # reference holds for the whole run, or (dense) into single-row rings
    # that every admission copies
    prefix_ids: List[int] = []
    pfx: dict = {}
    if paged and p_fix:
        prefix_ids = pool.alloc(paging.blocks_for(p_fix, bs))
        pfx = {"row_tbl": paging.build_table(prefix_ids, o.t_blocks)[None]}
    elif p_fix:
        pfx = fresh_rows()
    for start, end, _ in (request_segments(p_fix + 1)[
            :resume_index(p_fix + 1)] if p_fix else []):
        write_segment(o.prefix[None, start:end].to(dev), start, pfx, False)
    # every request is queued from here on
    tel.loop_started(len(reqs), slots, spec,
                     scheduler="continuous" if o.continuous else "slot",
                     device=dev)
    if paged:
        tel.pool_configured(o.pool_blocks, bs,
                            "cuda" if dev.type == "cuda" else "plain")
    blocks_in_use()  # the prefix's blocks, if any
    if o.adopt is not None:
        # completed-at-prefill handoffs carry no export: answer them
        # without a lane
        for i, h in enumerate(o.adopt):
            if not h.completed:
                continue
            tel.request_admitted(i, -1)
            tel.request_activated(i, 0)
            results[i] = ServeResult(
                tokens=[int(h.first_token)], admitted_at_step=0,
                finished_at_step=0, slot=-1)
            tel.request_finished(i, results[i], 0)
        queue = deque(i for i in queue if not o.adopt[i].completed)

    def release_shared(ids: List[int]) -> None:
        if registry is not None:
            registry.release(ids)
        else:
            pool.decref(ids)

    def release(s: int) -> None:
        """Free lane s's blocks (shared ones through the registry when
        there is one); its table row goes back to all-scratch so the
        frozen lane's pinned writes can never land in a block the
        allocator hands to someone else."""
        lane_rot.pop(s, None)
        if lane_shared[s]:
            release_shared(lane_shared[s])
        if lane_own[s]:
            pool.decref(lane_own[s])
        lane_shared[s], lane_own[s] = [], []
        lane_nblocks[s] = 0
        if paged:
            table[s] = 0

    def finish(s: int) -> None:
        nonlocal hold
        hold = False
        frozen_py[s] = True
        ridx = owner[s]
        results[ridx] = ServeResult(
            tokens=emitted[s], admitted_at_step=admitted_step[s],
            finished_at_step=n_step, slot=s,
            accepted_drafts=spec_acc[s][0], proposed_drafts=spec_acc[s][1],
            kv_blocks=lane_nblocks[s])
        owner[s] = None
        release(s)
        blocks_in_use()
        tel.request_finished(ridx, results[ridx], n_step)

    def admit(s: int, ridx: int, n_blocks: int) -> None:
        """Lane s takes the queue head with n_blocks fresh blocks after
        the shared prefix's whole blocks (increfed; a partial boundary
        block is copied into the first fresh one, in the draft's pools
        too); its prompt streams through its own row table from
        resume_index, and its batch row stays all scratch until
        activation.  A windowed lane's last `rotated` fresh blocks are
        its shadows, outside the table until the ring wraps onto a
        shared slot."""
        queue.popleft()
        _, shared_i, _, cow, rotated = o.plans[ridx]
        own = pool.alloc(n_blocks)
        slot_ids = own[:n_blocks - rotated]
        shared_ids = prefix_ids[:shared_i]
        if shared_ids:
            pool.incref(shared_ids)
            tel.prefix_blocks_reused(len(shared_ids))
        if cow:
            paging.copy_block(cache, prefix_ids[shared_i], slot_ids[0])
            if spec:
                paging.copy_block(d_cache, prefix_ids[shared_i], slot_ids[0])
            tel.cow_copy()
        lane_shared[s] = list(shared_ids)
        lane_own[s] = own
        lane_nblocks[s] = shared_i + n_blocks
        row = shared_ids + slot_ids
        if o.windowed:
            lane_rot[s] = paging.WindowRotation(
                row + [paging.SCRATCH_BLOCK] * (o.t_blocks - len(row)),
                shared_i, own[n_blocks - rotated:], bs, cfg.sliding_window)
        pending[s] = {
            "ridx": ridx, "next": resume_index(int(reqs[ridx].shape[0])),
            "row_tbl": paging.build_table(row, o.t_blocks)[None]}
        tel.request_admitted(ridx, s)
        tel.blocks_in_use(pool.used)

    def admit_dense(s: int) -> None:
        """Dense mode: lane s takes the queue head at once (no memory
        gate: every lane owns its rings); its prompt streams into fresh
        single-row rings."""
        ridx = queue.popleft()
        pending[s] = dict(fresh_rows(), ridx=ridx, next=resume_index(
            int(reqs[ridx].shape[0])))
        tel.request_admitted(ridx, s)

    def rotate_window(s: int, upto_pos: int, q_min: int) -> None:
        """A windowed lane's ring rotations for every block it is about
        to write through `upto_pos`, made before the dispatch that
        writes there: each wrapped-onto shared slot gets its shadow in
        the host table the dispatch uploads (the pending row, or the
        live one), the shadow first taking a copy of the shared block
        while any of its positions is inside the window of a query at
        q_min or later; then the shared id is dropped (through the
        registry when there is one)."""
        rot = lane_rot.get(s)
        if rot is None:
            return
        edits, released, evicted = rot.advance(upto_pos, q_min)
        row = pending[s]["row_tbl"][0] if s in pending else table[s]
        for slot, new_id, copy_src in edits:
            if copy_src is not None:
                paging.copy_block(cache, copy_src, new_id)
            row[slot] = new_id
        if released:
            release_shared(released)
            for rid in released:
                lane_shared[s].remove(rid)
            tel.blocks_in_use(pool.used)
        if evicted:
            tel.window_blocks_evicted(evicted)

    def export_lane(s: int, ridx: int) -> paging.BlockExport:
        """Lane s's blocks in wire form; only whole shared-prefix blocks
        are dedupe-eligible (a CoW boundary block's tail is the lane's
        own).  A linear lane ships its prompt's blocks in position
        order; a windowed one ships its ring's non-scratch slots in slot
        order with `window`, the JAX package's window_meta: the ring's
        width, each slot's index into the shipped blocks (-1: scratch),
        the slots still holding shared blocks and the rotation cursor,
        so the decode side resumes the ring where it stopped."""
        rot = lane_rot.get(s)
        window_meta = None
        if rot is not None:
            ids, shared, slots_map = [], [], []
            for slot_i, bid in enumerate(rot.slots):
                if bid == paging.SCRATCH_BLOCK:
                    slots_map.append(-1)
                    continue
                slots_map.append(len(ids))
                ids.append(bid)
                shared.append(slot_i in rot.shared_slots)
            window_meta = {"ring": len(rot.slots), "slots": slots_map,
                           "shared_slots": sorted(rot.shared_slots),
                           "next_block": rot.next_block}
        else:
            n_blk = paging.blocks_for(int(reqs[ridx].shape[0]), bs)
            ids = (lane_shared[s] + lane_own[s])[:n_blk]
            shared = [i < len(lane_shared[s]) for i in range(len(ids))]
        t0 = time.perf_counter()
        exp = paging.export_blocks(cache, ids, shared, bs,
                                   sent_hashes=sent_hashes,
                                   window=window_meta, sharding=pool_sh)
        tel.handoff_exported(len(exp), exp.payload_blocks(),
                             time.perf_counter() - t0)
        return exp

    def activate_lane(s: int, first: int, dev_done: bool = False) -> None:
        """The lane goes live with its first token; its table row becomes
        real only now.  dev_done: a fused fill already set tok/pos.
        prefill_only: the lane's job ends here, so it ships its blocks
        (unless the request already finished) and frees the lane."""
        st = pending.pop(s)
        ridx = st["ridx"]
        p_len = int(reqs[ridx].shape[0])
        if paged:
            table[s] = st["row_tbl"][0]
        owner[s] = ridx
        spec_acc[s] = (0, 0)
        admitted_step[s] = n_step
        emitted[s] = [first]
        if not dev_done:
            tok[s] = first
            pos[s] = p_len
        frozen_py[s] = False
        tel.request_activated(ridx, n_step)
        done = first == eos or budgets[ridx] == 1
        if o.prefill_only:
            handoffs[ridx] = KVHandoff(
                rid=ridx, prompt_len=p_len, budget=budgets[ridx],
                first_token=first, prefix_len=p_fix, completed=done,
                export=None if done else export_lane(s, ridx))
            finish(s)
            return
        if done:
            finish(s)

    def admit_adopt(s: int) -> bool:
        """Admit the queue head into lane s by ADOPTING its handoff: the
        blocks arrive written and the lane goes live at once with the
        prefill side's first token.  The memory gate covers the export's
        fresh blocks (dedup hits are increfs) plus this side's decode
        growth, which the continuous scheduler grows lazily behind its
        step gate for a linear lane.  A windowed lane's growth is its
        ring's tail slots still scratch in the export (the sender's
        prompt-only plan never reserved them) plus a shadow for each
        wrap still to come onto a surviving shared slot; its rotation
        resumes mid-ring from the export's `window`.  False = the gate
        held (FIFO: stop admitting)."""
        ridx = queue[0]
        exp = o.adopt_exports[ridx]
        p_len = int(reqs[ridx].shape[0])
        fresh = paging.adoption_cost(exp, registry)
        win = exp.window
        if o.windowed:
            shs = set(win["shared_slots"])
            smap = win["slots"]
            last = (p_len + budgets[ridx] + o.steps_per_sync - 2) // bs
            tail_slots: List[int] = []
            shadow_n = 0
            seen: set = set()
            for j in range(p_len // bs, last + 1):
                sl = j % win["ring"]
                if sl in seen:
                    continue
                seen.add(sl)
                if smap[sl] < 0:
                    tail_slots.append(sl)
                elif sl in shs and j >= win["next_block"]:
                    shs.discard(sl)
                    shadow_n += 1
            growth = len(tail_slots) + shadow_n
            if not pool.can_alloc(fresh + growth):
                tel.admission_blocked_on_memory(ridx)
                return False
        elif o.continuous:
            growth = 0
            if hold or not paging.step_gate(pool.free_blocks, fresh,
                                            len(in_flight())):
                tel.admission_blocked_on_memory(ridx)
                return False
        else:
            growth = o.plans[ridx][0] - paging.blocks_for(p_len, bs)
            if not pool.can_alloc(fresh + growth):
                tel.admission_blocked_on_memory(ridx)
                return False
        queue.popleft()
        t0 = time.perf_counter()
        _, adopted, sh_ids, own_ids, st = paging.adopt_blocks(
            cache, pool, exp, registry, sharding=pool_sh)
        grow = pool.alloc(growth) if growth else []
        lane_shared[s] = sh_ids
        lane_own[s] = own_ids + grow
        lane_nblocks[s] = len(adopted) + len(grow)
        tel.handoff_adopted(st["fresh"], st["deduped"],
                            time.perf_counter() - t0)
        if st["deduped"]:
            tel.prefix_blocks_reused(st["deduped"])
        row = adopted + grow
        if o.windowed:
            row = [paging.SCRATCH_BLOCK] * win["ring"]
            for slot_i, idx in enumerate(win["slots"]):
                if idx >= 0:
                    row[slot_i] = adopted[idx]
            for sl, bid in zip(tail_slots, grow):
                row[sl] = bid
            rot = paging.WindowRotation(row, 0, grow[len(tail_slots):], bs,
                                        cfg.sliding_window)
            rot.shared_slots = set(win["shared_slots"])
            rot.next_block = win["next_block"]
            lane_rot[s] = rot
        table[s] = paging.build_table(row, o.t_blocks)
        first = int(o.adopt[ridx].first_token)
        owner[s] = ridx
        spec_acc[s] = (0, 0)
        admitted_step[s] = n_step
        emitted[s] = [first]
        tok[s] = first
        pos[s] = p_len
        frozen_py[s] = False
        # JAX's order: the adoption, then admitted, then activated (TTFT
        # runs from the adopted lane's admission to its first token)
        tel.request_admitted(ridx, s)
        tel.blocks_in_use(pool.used)
        tel.request_activated(ridx, n_step)
        return True

    def advance_prefill(s: int) -> None:
        """Stream up to prefill_chunks_per_sync segments of slot s's
        pending prompt into its blocks (the draft's too); the final
        segment's logits give the first token and activate the lane.
        The continuous scheduler first grows the lane's coverage for
        each segment (and stops if that preempted the lane itself)."""
        st = pending[s]
        ridx = st["ridx"]
        prompt = reqs[ridx]
        segments = segments_of(ridx)
        budget = o.chunks_per_sync or len(segments)
        for start, end, is_last in segments[st["next"]:st["next"] + budget]:
            if lazy and not grow_or_preempt(s, end):
                return
            piece = prompt[None, start:end].to(dev)
            st["next"] += 1
            # a prompt streaming through a ring may wrap onto shared
            # slots: the segment's queries start at `start`
            rotate_window(s, end - 1, start)
            with tel.prefill_segment(ridx, start, end):
                logits = write_segment(piece, start, st, is_last)
                if is_last:
                    if not paged:
                        insert_row(cache, st["row"], s, o.sh)
                        if spec:
                            insert_row(d_cache, st["d_row"], s, o.d_sh)
                    first = int(select(logits)[0])  # device sync
            if is_last:
                activate_lane(s, first)
                return

    # ---------------------------------------- continuous-only bookkeeping
    def in_flight() -> List[int]:
        return [s for s in range(slots)
                if owner[s] is not None or s in pending]

    def lane_ridx(s: int) -> int:
        return pending[s]["ridx"] if s in pending else owner[s]

    def live_lanes() -> List[int]:
        return [s for s in range(slots)
                if owner[s] is not None and not frozen_py[s]]

    def ensure_cover(s: int, upto: int) -> bool:
        """Grow lane s's coverage to positions [0, upto); False (nothing
        changed) when the pool cannot supply the blocks.  Coverage counts
        table entries, shared prefix blocks included."""
        covered = len(lane_shared[s]) + len(lane_own[s])
        need = paging.blocks_to_cover(upto, covered, bs)
        if need == 0:
            return True
        if not pool.can_alloc(need):
            return False
        new_ids = pool.alloc(need)
        row = pending[s]["row_tbl"][0] if s in pending else table[s]
        row[covered:covered + need] = torch.tensor(new_ids,
                                                   dtype=torch.int32)
        lane_own[s].extend(new_ids)
        lane_nblocks[s] += need
        tel.blocks_in_use(pool.used)
        return True

    def preempt(s: int) -> None:
        """Back to the head of the queue: the lane's blocks are freed
        (its prefill is redone on re-admission) and admissions hold until
        a finish frees real capacity."""
        nonlocal hold
        ridx = lane_ridx(s)
        if s in pending:
            del pending[s]
        else:
            owner[s] = None
        frozen_py[s] = True
        release(s)
        emitted[s] = []
        queue.appendleft(ridx)
        hold = True
        tel.preempted_to_queue(ridx)
        tel.blocks_in_use(pool.used)

    def grow_or_preempt(s: int, upto: int) -> bool:
        """ensure_cover, preempting the youngest request in flight until
        it fits.  False iff s itself was the youngest."""
        while not ensure_cover(s, upto):
            victim = max(in_flight(), key=lane_ridx)
            preempt(victim)
            if victim == s:
                return False
        return True

    def admit_free_lanes() -> None:
        """Lazy admission: the queue head needs only its first segment's
        blocks beyond the shared prefix now (increfs cost none), plus one
        block per request in flight (step_gate).  Under adopt, admission
        adopts the handoff instead."""
        for s in range(slots):
            if not queue:
                return
            if owner[s] is not None or s in pending:
                continue
            if o.adopt is not None:
                if not admit_adopt(s):
                    return
                continue
            if not paged:
                admit_dense(s)
                continue
            ridx = queue[0]
            if not lazy:
                # a windowed lane reserves its whole ring plan, a
                # speculative one its worst case
                if not pool.can_alloc(o.plans[ridx][2]):
                    tel.admission_blocked_on_memory(ridx)
                    return
                admit(s, ridx, o.plans[ridx][2])
                continue
            if hold:
                return
            first_end = segments_of(ridx)[
                resume_index(int(reqs[ridx].shape[0]))][1]
            need_now = paging.blocks_to_cover(first_end, o.plans[ridx][1],
                                              bs)
            if not paging.step_gate(pool.free_blocks, need_now,
                                    len(in_flight())):
                tel.admission_blocked_on_memory(ridx)
                return
            admit(s, ridx, need_now)

    def spec_dispatch(n_rounds: int, busy: int) -> Tuple[list, list]:
        """n_rounds speculation rounds for every lane, as one decode
        block: one readback of the rounds' candidates [n_rounds][B][k+1]
        and accepted counts [n_rounds][B] (-1: frozen)."""
        nonlocal tok, pos
        temp, top_k, top_p, gen = o.sampling
        k = o.spec_k
        with tel.decode_block(busy, pool.used if paged else None):
            tok, pos, cands, n_accs = _spec.spec_block(
                model, o.draft, cache, d_cache, tok, pos,
                torch.tensor(frozen_py).to(dev), dev_table(), n_rounds, k,
                temp, top_k, top_p, gen)
            flat = torch.cat([cands.reshape(-1),
                              n_accs.reshape(-1)]).tolist()  # device sync
        tel.step_mix(busy, 0)
        n_c = n_rounds * slots * (k + 1)
        c_rows = [[flat[(i * slots + s) * (k + 1):(i * slots + s + 1) * (k + 1)]
                   for s in range(slots)] for i in range(n_rounds)]
        a_rows = [flat[n_c + i * slots:n_c + (i + 1) * slots]
                  for i in range(n_rounds)]
        return c_rows, a_rows

    def emit_rounds(c_rows: list, a_rows: list) -> None:
        """The host's side of a speculative block: each live lane's
        round tokens in order, its drafts counted, a finish where it hits
        EOS or its budget (the rest of the block is overshoot)."""
        nonlocal n_step
        n_rounds = len(a_rows)
        waste = 0
        for i in range(n_rounds):
            n_step += 1
            for s in range(slots):
                if owner[s] is None or frozen_py[s]:
                    continue
                acc, prop = spec_acc[s]
                spec_acc[s] = (acc + a_rows[i][s], prop + o.spec_k)
                bud = budgets[owner[s]]
                for t in c_rows[i][s][:a_rows[i][s] + 1]:
                    emitted[s].append(t)
                    if t == eos or len(emitted[s]) >= bud:
                        finish(s)
                        waste += n_rounds - 1 - i
                        break
        tel.lane_wasted_steps(waste)

    def run_continuous() -> None:
        nonlocal tok, pos, n_step, hold
        # a prompt segment rides the decode dispatch through its own row
        # table: paged, non-speculative serving only
        fused = paged and not spec
        while queue or pending or any(w is not None for w in owner):
            if hold and not in_flight():
                hold = False  # the pool drained; retry
            admit_free_lanes()
            live = live_lanes()
            if not fused or not live:
                # nothing to fuse with (or dense rings, or speculation,
                # which fuse nothing): stream pending prompts the slot
                # way, oldest request first
                for s in sorted(pending, key=lambda s: pending[s]["ridx"]):
                    if s in pending:  # a peer's growth may evict it
                        advance_prefill(s)
                live = live_lanes()
                if not live:
                    continue
            if spec:
                # rounds cut to the longest remaining budget; lanes
                # freeze on the host (the -1 marker skips frozen ones)
                max_rem = max(budgets[owner[s]] - len(emitted[s])
                              for s in live)
                n_rounds = min(o.steps_per_sync,
                               -(-max_rem // (o.spec_k + 1)))
                emit_rounds(*spec_dispatch(n_rounds, len(live)))
                continue
            n = min(o.steps_per_sync,
                    max(budgets[owner[s]] - len(emitted[s]) for s in live))
            seg_plan = None
            if fused and pending:
                # fuse the OLDEST pending lane's next segment
                s_pre = min(pending, key=lambda s: pending[s]["ridx"])
                st = pending[s_pre]
                start, end, is_last = segments_of(st["ridx"])[st["next"]]
                if not lazy or grow_or_preempt(s_pre, end):
                    rotate_window(s_pre, end - 1, start)
                    seg_plan = (s_pre, start, end, is_last)
            if lazy:
                # grow every live lane for this block's writes, oldest
                # request first (a young lane under pressure preempts
                # itself)
                for s in sorted(live, key=lambda s: owner[s]
                                if owner[s] is not None else slots):
                    if owner[s] is None or frozen_py[s]:
                        continue  # preempted by a senior's growth
                    r = owner[s]
                    p_len = int(reqs[r].shape[0])
                    grow_or_preempt(s, min(p_len + len(emitted[s]) - 1 + n,
                                           p_len + budgets[r]))
                live = live_lanes()
                if seg_plan is not None and seg_plan[0] not in pending:
                    seg_plan = None  # the pending lane lost its blocks
                if not live:
                    continue
                n = min(n, max(budgets[owner[s]] - len(emitted[s])
                               for s in live))
            else:
                # rotate every live ring for this block's writes; its
                # earliest query is the lane's current position
                for s in live:
                    cur = int(reqs[owner[s]].shape[0]) + len(emitted[s]) - 1
                    rotate_window(s, cur + n - 1, cur)
            live_set = set(live)
            left = torch.tensor([budgets[owner[s]] - len(emitted[s])
                                 if s in live_set else 0
                                 for s in range(slots)],
                                dtype=torch.int32).to(dev)
            frozen = torch.tensor(frozen_py).to(dev)
            table_d = dev_table()
            busy = len(live)
            seg_tok = 0
            first_dev = None
            with tel.decode_block(busy, pool.used if paged else None):
                if seg_plan is not None:
                    s_pre, start, end, is_last = seg_plan
                    st = pending[s_pre]
                    piece = reqs[st["ridx"]][None, start:end].to(dev)
                    row = st["row_tbl"].to(dev)
                    if is_last:
                        tok, pos, toks, lives, first_dev = fused_fill(
                            model, cache, tok, pos, frozen, left, eos,
                            table_d, piece, start, row, s_pre, n, select)
                    else:
                        tok, pos, toks, lives = fused_write(
                            model, cache, tok, pos, frozen, left, eos,
                            table_d, piece, start, row, n, select)
                    st["next"] += 1
                    seg_tok = end - start
                else:
                    tok, pos, toks, lives = cb_decode_block(
                        model, cache, tok, pos, frozen, left, eos, table_d,
                        n, select)
                toks_h, lives_h, first = _readback(toks, lives, first_dev)
            tel.step_mix(busy, seg_tok)
            waste = 0
            for i in range(n):
                n_step += 1
                for s in range(slots):
                    if owner[s] is None or frozen_py[s] or not lives_h[i][s]:
                        continue
                    t = toks_h[i][s]
                    emitted[s].append(t)
                    if t == eos or len(emitted[s]) >= budgets[owner[s]]:
                        finish(s)
                        # the device froze the lane; its remaining rows
                        # still computed (masked) to the block edge
                        waste += n - 1 - i
            tel.lane_wasted_steps(waste)
            if seg_plan is not None and seg_plan[3]:
                activate_lane(seg_plan[0], first, dev_done=True)

    def run_slot() -> None:
        nonlocal tok, pos, n_step
        while queue or pending or any(w is not None for w in owner):
            # admission: every free lane reserves the queue head's worst
            # case of blocks, FIFO — the head waits until the pool covers
            # (or, under adopt, adopts its handoff)
            for s in range(slots):
                if owner[s] is None and s not in pending and queue:
                    if o.adopt is not None:
                        if not admit_adopt(s):
                            break
                        continue
                    if not paged:
                        admit_dense(s)
                        continue
                    ridx = queue[0]
                    private_i = o.plans[ridx][2]
                    if not pool.can_alloc(private_i):
                        tel.admission_blocked_on_memory(ridx)
                        break
                    admit(s, ridx, private_i)
            for s in list(pending):
                advance_prefill(s)
            if all(w is None for w in owner):
                continue  # nothing decoding yet; keep prefilling/admitting
            # lanes owned by a live request this block (finish clears the
            # owner, so owned == decoding)
            busy = sum(1 for w in owner if w is not None)
            if spec:
                # steps_per_sync rounds; a lane that finishes mid-block
                # speculates to the block edge and the host discards it
                emit_rounds(*spec_dispatch(o.steps_per_sync, busy))
                continue
            # rotate every live ring for the positions this block writes
            # (a lane finishing mid-block still writes to the block edge)
            for s in live_lanes():
                cur = int(reqs[owner[s]].shape[0]) + len(emitted[s]) - 1
                rotate_window(s, cur + o.steps_per_sync - 1, cur)
            with tel.decode_block(busy, pool.used if paged else None):
                frozen = torch.tensor(frozen_py).to(dev)
                tok, pos, toks = decode_block(model, cache, tok, pos, frozen,
                                              dev_table(), o.steps_per_sync,
                                              select)
                block = toks.cpu().tolist()  # [steps_per_sync][B]; sync
            tel.step_mix(busy, 0)
            waste = 0
            for i in range(o.steps_per_sync):
                n_step += 1
                for s in range(slots):
                    if owner[s] is None or frozen_py[s]:
                        continue
                    t = block[i][s]
                    emitted[s].append(t)
                    if t == eos or len(emitted[s]) >= budgets[owner[s]]:
                        finish(s)  # later in-block tokens are overshoot
                        waste += o.steps_per_sync - 1 - i
            tel.lane_wasted_steps(waste)

    (run_continuous if o.continuous else run_slot)()
    return handoffs if o.prefill_only else results
