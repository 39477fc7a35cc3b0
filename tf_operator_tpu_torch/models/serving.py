"""Slot-scheduled paged serving loop.

The port of tf_operator_tpu/models/serving.serve_loop's paged slot path.
A fixed batch of `slots` decode lanes shares one KV block pool; requests
wait in a FIFO queue and are admitted into free lanes when the pool
covers their worst case (prompt + max_new_tokens blocks — the memory
gate, which never lets a smaller request overtake the head).  An
admitted prompt prefills straight into its lane's blocks, segment by
segment (`prefill_chunk`); the last segment's logits give the first
token, and the lane goes live.  Every `steps_per_sync` decode steps run
as one block for all lanes, each at its own position, before the host
reads the tokens back, detects EOS and budgets, frees finished lanes'
blocks and admits more.  Frozen lanes (free, or finished) keep stepping
with their position pinned and their table all scratch, so their writes
land in the scratch block; a lane that finishes mid-block computes to
the block edge and the host discards the overshoot.

The host schedule is the JAX package's algorithm step for step, so a
greedy run gives the same tokens AND the same admitted_at_step,
finished_at_step, slot and kv_blocks per request.  Every KV read goes
through models/paged_attention: the CUDA kernel on the card, its plain
version on the CPU.

Not ported yet — each raises NotImplementedError naming its ROADMAP item:
dense (non-paged) mode, the continuous scheduler, speculative decoding,
shared prefixes, int8 KV, weight transforms, cache sharding, sliding
windows, the prefill/decode handoff, prefill_chunks_per_sync and the
telemetry object.
"""
from __future__ import annotations

import dataclasses
import numbers
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models import llama as _llama
from tf_operator_tpu_torch.models import paging


@dataclasses.dataclass
class ServeResult:
    """Per-request outcome: the emitted tokens (EOS included when hit)
    and its schedule — the step its lane went live, the step it
    finished, its lane, and the KV blocks its table referenced."""

    tokens: List[int]
    admitted_at_step: int
    finished_at_step: int
    slot: int
    kv_blocks: int = 0


@dataclasses.dataclass
class ServeStats:
    """Aggregate of one serve_loop run: the subset of the JAX package's
    ServeStats (models/telemetry.py) that the slot loop fills.  Times
    are host wall-clock in seconds; a decode block's time ends at its
    token readback and a request's first token at its readback, both
    device barriers.  TTFT runs from lane admission to the first token,
    queue wait from the loop's start to admission."""

    requests: int = 0
    slots: int = 0
    scheduler: str = "slot"
    # which paged read served the run: "cuda" (the kernel) or "plain"
    paged_kernel: str = ""
    kv_block_size: int = 0
    kv_blocks_total: int = 0
    kv_blocks_peak_used: int = 0
    admissions_blocked_on_memory: int = 0
    # lane-steps computed past a finish, up to the block edge
    wasted_lane_steps: int = 0
    total_tokens: int = 0
    wall_time_s: float = 0.0
    tokens_per_sec: float = 0.0
    queue_wait_mean_s: float = 0.0
    ttft_mean_s: float = 0.0
    ttft_max_s: float = 0.0
    prefill_time_s: float = 0.0
    decode_time_s: float = 0.0
    per_request: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)


def _refuse(name: str, item: str) -> None:
    raise NotImplementedError(
        f"serve_loop: {name} is not ported yet (ROADMAP Queue 1: {item})")


def decode_block(model: _llama.Llama, cache, tok: torch.Tensor,
                 pos: torch.Tensor, frozen: torch.Tensor,
                 table: torch.Tensor, n_steps: int, select
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """n_steps single-token decode steps for every lane, each at its own
    position.  Frozen lanes emit their token unchanged and do not
    advance.  Returns (tok, pos, tokens [n_steps, B]) on the device."""
    toks = []
    for _ in range(n_steps):
        logits = model(tok[:, None], cache, pos, table)
        nxt = torch.where(frozen, tok, select(logits[:, 0]))
        pos = torch.where(frozen, pos, pos + 1)
        tok = nxt
        toks.append(nxt)
    return tok, pos, torch.stack(toks)


def chunk_fill(model: _llama.Llama, cache, segment: torch.Tensor,
               start: int, table: torch.Tensor) -> torch.Tensor:
    """The final prefill segment [1, S] into the lane's blocks ([1, T]
    table): returns the last position's f32 logits [1, V]."""
    h = model(segment, cache, start, table, return_hidden=True)
    return model.logits(h[:, -1])


def chunk_write(model: _llama.Llama, cache, segment: torch.Tensor,
                start: int, table: torch.Tensor) -> None:
    """A non-final prefill segment: feeds the blocks only (no lm_head)."""
    model(segment, cache, start, table, return_hidden=True)


def serve_loop(model: _llama.Llama, requests: Sequence[Any], *,
               slots: int = 4, max_new_tokens: Union[int, Sequence[int]] = 64,
               eos_id: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
               generator: Optional[torch.Generator] = None,
               prefill_chunk: Optional[int] = None,
               steps_per_sync: int = 8,
               paged: bool = True, block_size: int = 64,
               pool_blocks: Optional[int] = None,
               scheduler: str = "slot",
               return_stats: bool = False,
               device: Union[str, torch.device, None] = None,
               draft=None, shared_prefix=None, kv_quant: bool = False,
               params_transform=None, cache_sharding=None,
               prefill_only: bool = False, adopt=None,
               prefill_chunks_per_sync: Optional[int] = None,
               telemetry=None):
    """Serve `requests` (1-D token sequences) through `slots` lanes over
    a paged KV pool; returns a ServeResult per request, in request order
    (with return_stats, (results, ServeStats)).

    max_new_tokens: one budget for every request or one per request.
    eos_id: a request that emits it finishes (EOS included in tokens).
    temperature / top_k / top_p: 0 = greedy; sampling draws from
    `generator`, a torch.Generator on `device`.
    prefill_chunk: prefill in segments of this many tokens (a multiple
    of block_size); None = one segment per prompt.
    steps_per_sync: decode steps per block between host syncs.
    block_size / pool_blocks: the pool's block size and usable blocks
    (default: every lane can hold the largest worst case at once —
    shrink it to engage the memory gate).
    device: where the model lives and the loop runs (default "cuda").

    The remaining keywords are the JAX serve_loop's options this port
    does not take yet; each raises NotImplementedError."""
    if not paged:
        _refuse("dense mode (paged=False)", "dense decode and generate")
    if scheduler == "continuous":
        _refuse("scheduler='continuous'", "continuous scheduler")
    if scheduler != "slot":
        raise ValueError(f"scheduler must be 'slot' or 'continuous', got "
                         f"{scheduler!r}")
    if draft is not None:
        _refuse("draft (speculative decoding)", "speculative decoding")
    if shared_prefix is not None:
        _refuse("shared_prefix", "shared-prefix blocks")
    if kv_quant:
        _refuse("kv_quant", "int8 KV and kernel K1q")
    if params_transform is not None:
        _refuse("params_transform", "int8 weights")
    if cache_sharding is not None:
        _refuse("cache_sharding", "distributed")
    if model.cfg.sliding_window is not None:
        _refuse("a sliding_window config", "sliding-window paged tables")
    if prefill_only or adopt is not None:
        _refuse("prefill_only / adopt", "disaggregated handoff")
    if prefill_chunks_per_sync is not None:
        _refuse("prefill_chunks_per_sync", "continuous scheduler")
    if telemetry is not None:
        _refuse("telemetry", "serving telemetry")

    cfg = model.cfg
    dev = resolve_device(device)
    p_dev = model.embed.device
    if p_dev.type != dev.type or (dev.index is not None
                                  and p_dev.index != dev.index):
        raise ValueError(f"model is on {p_dev}, serve_loop asked for {dev}")
    reqs = [torch.as_tensor(r, dtype=torch.long).reshape(-1).cpu()
            for r in requests]
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
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    if steps_per_sync < 1:
        raise ValueError(f"steps_per_sync must be >= 1, got {steps_per_sync}")
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if prefill_chunk is not None:
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if prefill_chunk % block_size:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must be a multiple of "
                f"block_size {block_size} so every streamed segment "
                f"writes whole blocks")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")
    _llama.check_truncation(cfg.vocab_size, top_k, top_p)
    if eos_id is not None and not 0 <= int(eos_id) < cfg.vocab_size:
        raise ValueError(
            f"eos_id {eos_id} out of range for vocab_size {cfg.vocab_size}")
    eos = -1 if eos_id is None else int(eos_id)
    for i, r in enumerate(reqs):
        if r.shape[0] < 1:
            raise ValueError(f"request {i} is empty")
        if r.shape[0] + budgets[i] > cfg.max_len:
            raise ValueError(
                f"request {i}: prompt {r.shape[0]} + new {budgets[i]} "
                f"exceeds max_len {cfg.max_len}")
    if not reqs:
        stats = ServeStats(slots=slots)
        return ([], stats) if return_stats else []

    # block math: the table covers the largest worst case; each plan is
    # (total, shared, private, cow) with no prefix and no headroom
    worst_total = max(int(r.shape[0]) + b for r, b in zip(reqs, budgets))
    t_blocks = paging.blocks_for(worst_total, block_size)
    plans = [paging.plan_request(int(r.shape[0]), budgets[i], 0, block_size)
             for i, r in enumerate(reqs)]
    if pool_blocks is None:
        pool_blocks = slots * max(pl[2] for pl in plans)
    if pool_blocks < 1:
        raise ValueError(f"pool_blocks must be >= 1, got {pool_blocks}")
    for i, (r, pl) in enumerate(zip(reqs, plans)):
        # the worst case must fit an EMPTY pool or the gate waits forever
        if pl[2] > pool_blocks:
            raise ValueError(
                f"request {i}: prompt {r.shape[0]} + new {budgets[i]} "
                f"needs {pl[2]} blocks of {block_size} tokens, but the "
                f"pool has {pool_blocks} — grow pool_blocks or shrink the "
                f"request")

    def select(logits: torch.Tensor) -> torch.Tensor:
        return _llama._select_token(logits, temperature, generator, top_k,
                                    top_p)

    with torch.inference_mode():
        return _run(model, reqs, budgets, slots, eos, prefill_chunk,
                    steps_per_sync, block_size, pool_blocks, t_blocks,
                    plans, select, dev, return_stats)


def _run(model, reqs, budgets, slots, eos, prefill_chunk, steps_per_sync,
         block_size, pool_blocks, t_blocks, plans, select, dev,
         return_stats):
    cfg = model.cfg
    t_start = time.perf_counter()
    pool = paging.BlockPool(pool_blocks, block_size)
    cache = paging.init_block_pool(cfg, pool_blocks, block_size,
                                   device=dev)
    table = torch.zeros((slots, t_blocks), dtype=torch.int32, device=dev)
    tok = torch.zeros((slots,), dtype=torch.long, device=dev)
    pos = torch.zeros((slots,), dtype=torch.int32, device=dev)
    frozen_py = [True] * slots
    owner: List[Optional[int]] = [None] * slots
    emitted: List[List[int]] = [[] for _ in range(slots)]
    results: List[Optional[ServeResult]] = [None] * len(reqs)
    admitted_step = [0] * slots
    lane_own: List[List[int]] = [[] for _ in range(slots)]
    lane_nblocks = [0] * slots
    queue = deque(range(len(reqs)))
    pending: Dict[int, dict] = {}
    n_step = 0
    # host clock marks per request: admitted, first token, finished
    t_admit = [0.0] * len(reqs)
    t_first = [0.0] * len(reqs)
    t_done = [0.0] * len(reqs)
    counts = {"blocked": 0, "wasted": 0, "peak": 0}
    seconds = {"prefill": 0.0, "decode": 0.0}

    def finish(s: int) -> None:
        frozen_py[s] = True
        ridx = owner[s]
        results[ridx] = ServeResult(
            tokens=emitted[s], admitted_at_step=admitted_step[s],
            finished_at_step=n_step, slot=s, kv_blocks=lane_nblocks[s])
        t_done[ridx] = time.perf_counter()
        owner[s] = None
        # free the lane's blocks; its table row goes back to all-scratch
        # so the frozen lane's pinned writes can never land in a block
        # the allocator hands to someone else
        if lane_own[s]:
            pool.decref(lane_own[s])
        lane_own[s] = []
        lane_nblocks[s] = 0
        table[s] = 0

    def activate_lane(s: int, first: int) -> None:
        """The lane goes live with its first token; its table row becomes
        real only now (it was scratch while pending)."""
        st = pending.pop(s)
        ridx = st["ridx"]
        table[s] = st["row_tbl"][0]
        owner[s] = ridx
        admitted_step[s] = n_step
        emitted[s] = [first]
        tok[s] = first
        pos[s] = int(reqs[ridx].shape[0])
        frozen_py[s] = False
        t_first[ridx] = time.perf_counter()
        if first == eos or budgets[ridx] == 1:
            finish(s)

    def advance_prefill(s: int) -> None:
        """Stream slot s's pending prompt into its blocks; the final
        segment's logits give the first token and activate the lane."""
        st = pending[s]
        prompt = reqs[st["ridx"]]
        segments = _llama.prefill_segments(int(prompt.shape[0]),
                                           prefill_chunk)
        for start, end, is_last in segments[st["next"]:]:
            piece = prompt[None, start:end].to(dev)
            st["next"] += 1
            t0 = time.perf_counter()
            if is_last:
                last_logits = chunk_fill(model, cache, piece, start,
                                         st["row_tbl"])
                first = int(select(last_logits)[0])  # device sync
                seconds["prefill"] += time.perf_counter() - t0
                activate_lane(s, first)
                return
            chunk_write(model, cache, piece, start, st["row_tbl"])
            seconds["prefill"] += time.perf_counter() - t0

    while queue or pending or any(o is not None for o in owner):
        # admission: every free lane reserves the queue head's worst case
        # of blocks, FIFO — the head waits until the pool covers it
        for s in range(slots):
            if owner[s] is None and s not in pending and queue:
                ridx = queue[0]
                private_i = plans[ridx][2]
                if not pool.can_alloc(private_i):
                    counts["blocked"] += 1
                    break
                queue.popleft()
                own = pool.alloc(private_i)
                lane_own[s] = own
                lane_nblocks[s] = private_i
                pending[s] = {
                    "ridx": ridx, "next": 0,
                    "row_tbl": paging.build_table(
                        own, t_blocks)[None, :].to(dev),
                }
                t_admit[ridx] = time.perf_counter()
                counts["peak"] = max(counts["peak"], pool.used)
        for s in list(pending):
            advance_prefill(s)
        if all(o is None for o in owner):
            continue  # nothing decoding yet; keep prefilling/admitting
        counts["peak"] = max(counts["peak"], pool.used)
        t0 = time.perf_counter()
        frozen = torch.tensor(frozen_py, device=dev)
        tok, pos, toks = decode_block(model, cache, tok, pos, frozen,
                                      table, steps_per_sync, select)
        block = toks.cpu().tolist()  # [steps_per_sync][B]; device sync
        seconds["decode"] += time.perf_counter() - t0
        for i in range(steps_per_sync):
            n_step += 1
            for s in range(slots):
                if owner[s] is None or frozen_py[s]:
                    continue
                t = block[i][s]
                emitted[s].append(t)
                if t == eos or len(emitted[s]) >= budgets[owner[s]]:
                    finish(s)  # later in-block tokens are overshoot
                    counts["wasted"] += steps_per_sync - 1 - i
    if not return_stats:
        return results
    wall = time.perf_counter() - t_start
    total = sum(len(r.tokens) for r in results)
    ttft = [t_first[i] - t_admit[i] for i in range(len(reqs))]
    stats = ServeStats(
        requests=len(reqs), slots=slots, scheduler="slot",
        paged_kernel="cuda" if dev.type == "cuda" else "plain",
        kv_block_size=block_size, kv_blocks_total=pool_blocks,
        kv_blocks_peak_used=counts["peak"],
        admissions_blocked_on_memory=counts["blocked"],
        wasted_lane_steps=counts["wasted"], total_tokens=total,
        wall_time_s=wall, tokens_per_sec=total / wall if wall > 0 else 0.0,
        queue_wait_mean_s=sum(t_admit[i] - t_start
                              for i in range(len(reqs))) / len(reqs),
        ttft_mean_s=sum(ttft) / len(ttft), ttft_max_s=max(ttft),
        prefill_time_s=seconds["prefill"],
        decode_time_s=seconds["decode"],
        per_request=[{
            "request": i, "slot": results[i].slot,
            "tokens": len(results[i].tokens),
            "queue_wait_s": t_admit[i] - t_start, "ttft_s": ttft[i],
            "e2e_latency_s": t_done[i] - t_start,
        } for i in range(len(reqs))])
    return results, stats
