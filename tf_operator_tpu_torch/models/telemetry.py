"""Serving telemetry: request lifecycle spans, latency histograms,
occupancy and acceptance accounting for models/serving.serve_loop.

The port of tf_operator_tpu/models/telemetry.py (`_RequestTimeline`,
`ServeStats`, `ServeTelemetry`), fed at the same points of the loop:

  - per-request lifecycle SPANS (engine/tracing.Span): queued ->
    prefill (one child per streamed segment) -> decode under one
    `serve_request` root, category "serving", one virtual trace lane per
    request, landed in the tracer by Tracer.record() as each request
    finishes.
  - latency HISTOGRAMS (engine/metrics serving families): TTFT (lane
    admission -> first token), TPOT (decode wall-clock per decoded
    token), queue wait (loop start -> lane reserved) and end-to-end
    request latency, each observed once per admission or finish.
  - GAUGES/COUNTERS: batch occupancy (sampled at every decode block),
    the prefill-vs-decode wall-clock split, request and token counters,
    speculative draft acceptance, and the paged pool's families (blocks
    total/used, CoW copies, prefix block hits, blocked admissions,
    window evictions, step mix, wasted lane-steps, the handoff).
  - an aggregate `ServeStats`, JAX's fields in JAX's order, returned by
    serve_loop(return_stats=True).

Where the port differs from the JAX module:

  - the request recorder is an argument: `reqtrace=None` (the default)
    records nothing, as JAX's process-global RequestRecorder does until
    an operator enables it.  Any object with `.enabled` and
    `.record(job_key, rid, plane, event, detail, ts=)` takes the
    records (JAX's engine.reqtrace.RequestRecorder among them);
  - `hbm_peak_bytes` is torch.cuda.max_memory_allocated of the loop's
    card, keyed by its name ("cuda:0"), and {} on the CPU.  Like JAX's
    it is the process peak: serve_loop resets nothing;
  - `paged_kernel` names the port's read paths: "cuda" (the kernels,
    K1 or K1q) or "plain" (their plain versions on the CPU), where JAX
    says "pallas" or "gather".  The paged-kernel counter's label takes
    the same values under the family's JAX HELP text.

Timing honesty: phases are measured at host boundaries the loop already
has.  A decode block ENDS at its token readback (a device barrier), so
decode time is real wall-clock; a prefill segment's time covers the host
dispatch of its writes, and the final segment's first-token readback
syncs the device.  Nothing here adds a device sync: telemetry does not
change the schedule it measures.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch

from tf_operator_tpu_torch.engine import metrics as em
from tf_operator_tpu_torch.engine.tracing import Span, Tracer, get_tracer


def _mean(xs: List[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


# Virtual trace-lane base for serving request spans: reconcile spans in
# the same export use OS native thread ids as tid, and in a container
# those are small integers — request index 3 must not land on worker
# thread 3's track.  The offset keeps the two span streams on disjoint
# Perfetto tracks (cat filtering separates colors, not tracks).
_LANE_BASE = 1 << 20


class _RequestTimeline:
    """Host-side timestamps for one request's lifecycle.  Everything is
    perf_counter: the telemetry anchors ONE (wall, perf) pair at loop
    start and derives every span's wall_start from it, so phase
    intervals nest exactly by construction — mixing per-event time.time()
    samples with perf_counter durations would let clock skew break the
    parent-contains-child invariant the trace viewer renders."""

    __slots__ = (
        "index", "queued_pc", "admitted_pc", "first_token_pc",
        "finished_pc", "slot", "prefill_s", "segments", "tokens",
        "accepted_drafts", "proposed_drafts", "admitted_at_step",
        "finished_at_step",
    )

    def __init__(self, index: int, pc: float) -> None:
        self.index = index
        self.queued_pc = pc
        self.admitted_pc: Optional[float] = None
        self.first_token_pc: Optional[float] = None
        self.finished_pc: Optional[float] = None
        self.slot: Optional[int] = None
        self.prefill_s = 0.0
        # (pc_start, duration, token_start, token_end) per segment
        self.segments: List[tuple] = []
        self.tokens = 0
        self.accepted_drafts = 0
        self.proposed_drafts = 0
        self.admitted_at_step = 0
        self.finished_at_step = 0

    # ------------------------------------------------------- derived
    def queue_wait_s(self) -> float:
        return self.admitted_pc - self.queued_pc

    def ttft_s(self) -> float:
        return self.first_token_pc - self.admitted_pc

    def e2e_latency_s(self) -> float:
        return self.finished_pc - self.queued_pc

    def tpot_s(self) -> Optional[float]:
        """Decode wall-clock per decoded token (first token excluded);
        None for single-token requests — there was no decode phase."""
        if self.tokens < 2:
            return None
        return (self.finished_pc - self.first_token_pc) / (self.tokens - 1)


@dataclasses.dataclass
class ServeStats:
    """Aggregate serving telemetry for one serve_loop run.  Latency
    aggregates summarize per-request numbers (the full per-request rows
    ride in `per_request`); occupancy is time-weighted over decode
    blocks; the prefill/decode split is loop-level wall-clock, so the
    two need not sum to wall_time_s (admission bookkeeping and host
    emission are neither)."""

    requests: int = 0
    slots: int = 0
    speculative: bool = False
    # which inner loop served the run: "slot" (block-synchronous
    # oracle) or "continuous" (token-level iteration scheduler)
    scheduler: str = "slot"
    # paged-KV accounting (serve_loop paged=True; zeros under dense
    # serving): pool capacity/peak in blocks, the time-weighted mean
    # block occupancy over decode blocks (the autoscaler's memory
    # signal), CoW/prefix-reuse counts, and how many serve-loop
    # iterations deferred an admission for pool capacity
    paged: bool = False
    # which paged read path served the run: "cuda" (the kernel, K1 or
    # K1q) or "plain" (its plain version on the CPU)
    paged_kernel: str = ""
    kv_block_size: int = 0
    kv_blocks_total: int = 0
    kv_blocks_peak_used: int = 0
    kv_block_occupancy_mean: float = 0.0
    cow_copies: int = 0
    prefix_block_hits: int = 0
    admissions_blocked_on_memory: int = 0
    # sliding-window paged serving: block epochs retired by table
    # rotation (shared prefix blocks dereferenced, private reused)
    window_evicted_blocks: int = 0
    # step-mix accounting: lane-steps computed for already-finished
    # lanes (the slot loop's post-EOS overshoot; the continuous
    # scheduler's in-block freeze residue), prefill tokens that rode a
    # fused prefill+decode dispatch, and preempt-to-queue evictions
    # (continuous scheduler's pressure valve; 0 under the slot loop)
    wasted_lane_steps: int = 0
    fused_prefill_tokens: int = 0
    preemptions: int = 0
    # disaggregated serving: lanes exported at the handoff point
    # (prefill_only runs) and exports adopted into this pool
    # (adopt= runs) — 0 for a unified loop
    handoff_exports: int = 0
    handoff_adoptions: int = 0
    total_tokens: int = 0
    wall_time_s: float = 0.0
    tokens_per_sec: float = 0.0
    queue_wait_mean_s: float = 0.0
    queue_wait_max_s: float = 0.0
    ttft_mean_s: float = 0.0
    ttft_max_s: float = 0.0
    tpot_mean_s: Optional[float] = None
    e2e_latency_mean_s: float = 0.0
    e2e_latency_max_s: float = 0.0
    prefill_time_s: float = 0.0
    decode_time_s: float = 0.0
    occupancy_mean: float = 0.0
    occupancy_max: int = 0
    accepted_drafts: int = 0
    proposed_drafts: int = 0
    acceptance_rate: Optional[float] = None
    hbm_peak_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    per_request: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    def summary(self, digits: int = 6) -> Dict[str, Any]:
        """Compact dict for JSON lines: the aggregate
        fields rounded, per-request rows dropped."""
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            if f.name == "per_request":
                continue
            v = getattr(self, f.name)
            out[f.name] = round(v, digits) if isinstance(v, float) else v
        return out


class ServeTelemetry:
    """The instrumentation object serve_loop drives.  One instance per
    serve_loop call; pass your own (e.g. with a private Tracer) via
    serve_loop(telemetry=...) or let the loop build one against the
    process-global tracer.  Metric families are registry-level and
    shared — concurrent serve loops aggregate, as scrape targets do."""

    def __init__(
        self,
        tracer: Optional[Tracer] = None,
        reqtrace: Any = None,
        job_key: str = "local/serve",
        request_ids: Optional[List[str]] = None,
    ) -> None:
        self.tracer = tracer or get_tracer()
        # request flight-recorder seam: the serving plane's records
        # (queued / admitted / prefill_chunk / first_token / finished /
        # memory_gate_block / preempted_to_queue) land on per-request
        # timelines of `reqtrace` when one is given and enabled; None
        # records nothing.  `request_ids` maps the loop's request INDEX
        # to a caller's request id.
        self.reqtrace = reqtrace
        self.job_key = job_key
        self.request_ids = list(request_ids) if request_ids else None
        self._reqs: Dict[int, _RequestTimeline] = {}
        self._done: List[_RequestTimeline] = []
        self._slots = 0
        self._spec = False
        self._started_pc: Optional[float] = None
        self._wall0 = 0.0  # epoch anchor for span placement
        self._prefill_s = 0.0
        self._decode_s = 0.0
        self._occ: List[tuple] = []  # (busy_lanes, block_duration)
        self._hbm: Optional[Dict[str, int]] = None  # set by loop_finished
        self._device: Optional[torch.device] = None  # the loop's card
        # paged-KV accounting (pool_configured + per-event methods)
        self._pool_total = 0
        self._pool_block_size = 0
        self._paged_kernel = ""
        self._blocks_occ: List[tuple] = []  # (blocks_used, duration)
        self._blocks_peak = 0
        self._cow = 0
        self._prefix_hits = 0
        self._adm_blocked = 0
        self._window_evicted = 0
        self._scheduler = "slot"
        self._wasted_lane_steps = 0
        self._fused_prefill_tokens = 0
        self._preemptions = 0
        self._handoff_exports = 0
        self._handoff_adoptions = 0

    def _wall(self, pc: float) -> float:
        """Epoch seconds for a perf_counter reading, via the single
        anchor pair sampled at loop start (see _RequestTimeline)."""
        return self._wall0 + (pc - (self._started_pc or pc))

    def _rid(self, index: int) -> str:
        if self.request_ids is not None and index < len(self.request_ids):
            return self.request_ids[index]
        return f"req{index}"

    def _rrecord(
        self, index: int, event: str, detail: Dict[str, Any], pc: float,
    ) -> None:
        if self.reqtrace is not None and self.reqtrace.enabled:
            self.reqtrace.record(
                self.job_key, self._rid(index), "serving", event, detail,
                ts=self._wall(pc),
            )

    # --------------------------------------------------------- lifecycle
    def loop_started(self, n_requests: int, slots: int,
                     speculative: bool,
                     scheduler: str = "slot", device=None) -> None:
        """A serve_loop run begins: every request is queued from here.
        `device` is the loop's device, whose memory peak loop_finished
        samples (None or the CPU: none)."""
        # fresh accumulators: an instance reused across serve_loop calls
        # must report the CURRENT run, not a merge (spans and registry
        # counters already landed; only the aggregate state resets)
        self._reqs.clear()
        self._done.clear()
        self._occ.clear()
        self._hbm = None
        self._device = None if device is None else torch.device(device)
        self._prefill_s = self._decode_s = 0.0
        self._pool_total = self._pool_block_size = 0
        self._paged_kernel = ""
        self._blocks_occ.clear()
        self._blocks_peak = self._cow = 0
        self._prefix_hits = self._adm_blocked = 0
        self._window_evicted = 0
        self._scheduler = scheduler
        self._wasted_lane_steps = 0
        self._fused_prefill_tokens = 0
        self._preemptions = 0
        self._handoff_exports = 0
        self._handoff_adoptions = 0
        # step-mix gauges sample the last dispatch; a fresh run must
        # not inherit the previous run's final step
        em.SERVING_STEP_DECODE_ROWS.set(0)
        em.SERVING_STEP_PREFILL_TOKENS.set(0)
        # a DENSE run must clear a prior paged run's capacity gauge or
        # the process keeps exporting a pool it no longer has ("0 means
        # dense serving" is the family's documented contract); a paged
        # run re-sets it via pool_configured right after.  USED resets
        # too: an ABORTED paged run (exception before loop_finished)
        # would otherwise leave used > 0 beside total == 0 and the
        # dashboards' used/total occupancy ratio would read +Inf
        em.SERVING_KV_BLOCKS_TOTAL.set(0)
        em.SERVING_KV_BLOCKS_USED.set(0)
        self._started_pc = time.perf_counter()
        self._wall0 = time.time()
        self._slots = slots
        self._spec = speculative
        for i in range(n_requests):
            self._reqs[i] = _RequestTimeline(i, self._started_pc)
            self._rrecord(i, "queued", {"slots": slots}, self._started_pc)

    # ------------------------------------------------------ paged cache
    def pool_configured(self, total_blocks: int, block_size: int,
                        kernel: str = "plain") -> None:
        """serve_loop announces its block pool: capacity gauge set once
        per run (used/total is the dashboards' block-occupancy ratio)
        and the resolved read path (cuda | plain), which labels the
        per-request kernel counter."""
        self._pool_total = total_blocks
        self._pool_block_size = block_size
        self._paged_kernel = kernel
        em.SERVING_KV_BLOCKS_TOTAL.set(total_blocks)
        em.SERVING_KV_BLOCKS_USED.set(0)

    def blocks_in_use(self, used: int) -> None:
        """Sample pool occupancy outside a decode block (admissions and
        finishes change it between blocks); peak tracking only — the
        time-weighted mean is carried by decode_block."""
        self._blocks_peak = max(self._blocks_peak, used)
        em.SERVING_KV_BLOCKS_USED.set(used)

    def cow_copy(self) -> None:
        self._cow += 1
        em.SERVING_KV_BLOCK_COW_COPIES.inc()

    def prefix_blocks_reused(self, n: int) -> None:
        if n > 0:
            self._prefix_hits += n
            em.SERVING_PREFIX_BLOCK_HITS.inc(amount=n)

    def admission_blocked_on_memory(self, index: Optional[int] = None) -> None:
        """One serve-loop iteration had a free lane and a queued request
        but the pool could not cover the request's worst case.  `index`
        (when the caller knows which request held the FIFO head) lands a
        memory_gate_block DECISION on that request's timeline."""
        self._adm_blocked += 1
        em.SERVING_ADMISSION_BLOCKED.inc()
        if index is not None:
            self._rrecord(
                index, "memory_gate_block",
                {"pool_blocks": self._pool_total}, time.perf_counter(),
            )

    def window_blocks_evicted(self, n: int) -> None:
        """Sliding-window rotation retired n block epochs: the modular
        table wrapped past their positions (shared prefix blocks were
        dereferenced, private blocks reused in place)."""
        if n > 0:
            self._window_evicted += n
            em.SERVING_KV_WINDOW_EVICTED.inc(amount=n)

    def step_mix(self, decode_rows: int, prefill_tokens: int) -> None:
        """One dispatched decode block's ragged composition: how many
        lanes decoded and how many prefill tokens rode the SAME device
        dispatch (0 everywhere except the continuous scheduler's fused
        prefill+decode steps).  Host-side bookkeeping only — no device
        sync rides on telemetry.  The gauges sample the latest
        dispatch (the scrape-time mix); the fused-token count also
        accumulates into ServeStats.fused_prefill_tokens."""
        em.SERVING_STEP_DECODE_ROWS.set(decode_rows)
        em.SERVING_STEP_PREFILL_TOKENS.set(prefill_tokens)
        if prefill_tokens > 0:
            self._fused_prefill_tokens += prefill_tokens

    def lane_wasted_steps(self, n: int) -> None:
        """n lane-steps were computed for already-finished lanes: the
        slot loop's run-to-the-block-edge overshoot, or the continuous
        scheduler's residue between an in-block device freeze and the
        block edge."""
        if n > 0:
            self._wasted_lane_steps += n
            em.SERVING_LANE_WASTED_STEPS.inc(amount=n)

    def handoff_exported(self, blocks: int, payload_blocks: int,
                         duration_s: float) -> None:
        """One lane's KV blocks left on the prefill→decode wire:
        `payload_blocks` carried bytes, the rest were elided by
        content hash (shared prefix already shipped to this
        receiver)."""
        self._handoff_exports += 1
        if payload_blocks > 0:
            em.SERVING_HANDOFF_BLOCKS.inc({"phase": "exported"},
                                          payload_blocks)
        if blocks - payload_blocks > 0:
            em.SERVING_HANDOFF_BLOCKS.inc({"phase": "elided"},
                                          blocks - payload_blocks)
        em.SERVING_HANDOFF_DURATION.observe(duration_s,
                                            {"side": "export"})

    def handoff_adopted(self, fresh: int, deduped: int,
                        duration_s: float) -> None:
        """One handoff landed in this decode replica's pool: `fresh`
        blocks allocated+written, `deduped` resolved to already-
        adopted blocks by content hash (incref, no bytes moved)."""
        self._handoff_adoptions += 1
        if fresh > 0:
            em.SERVING_HANDOFF_BLOCKS.inc({"phase": "adopted"}, fresh)
        if deduped > 0:
            em.SERVING_HANDOFF_BLOCKS.inc({"phase": "deduped"},
                                          deduped)
        em.SERVING_HANDOFF_DURATION.observe(duration_s,
                                            {"side": "adopt"})

    def preempted_to_queue(self, index: int) -> None:
        """The continuous scheduler evicted a lane under block-pool
        pressure and re-queued its request (it will re-admit and
        recompute; no tokens were lost, the emitted list reset)."""
        self._preemptions += 1
        self._rrecord(index, "preempted_to_queue",
                      {"pool_blocks": self._pool_total},
                      time.perf_counter())

    def request_admitted(self, index: int, slot: int) -> None:
        """A decode lane was RESERVED for the request (its prompt may
        still stream in over many loop iterations) — queue wait ends
        here, the prefill phase begins."""
        r = self._reqs[index]
        r.admitted_pc = time.perf_counter()
        r.slot = slot
        em.SERVING_QUEUE_WAIT.observe(r.queue_wait_s())
        self._rrecord(index, "admitted", {
            "slot": slot, "queue_wait_s": round(r.queue_wait_s(), 6),
        }, r.admitted_pc)

    @contextmanager
    def prefill_segment(self, index: int, tok_start: int, tok_end: int):
        """Time one streamed prompt segment (chunk write or final fill +
        lane insert).  Non-final segments measure host dispatch; the
        final segment includes the first-token fetch's device sync."""
        r = self._reqs[index]
        pc = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - pc
            r.segments.append((pc, dt, tok_start, tok_end))
            r.prefill_s += dt
            self._prefill_s += dt
            em.SERVING_PREFILL_TIME.inc(amount=dt)
            self._rrecord(index, "prefill_chunk", {
                "token_start": tok_start, "token_end": tok_end,
                "duration": round(dt, 6),
            }, pc + dt)

    def request_activated(self, index: int, step: int) -> None:
        """First token sampled, lane live: TTFT is measurable."""
        r = self._reqs[index]
        r.first_token_pc = time.perf_counter()
        r.admitted_at_step = step
        em.SERVING_TTFT.observe(r.ttft_s())
        self._rrecord(index, "first_token", {
            "step": step, "ttft_s": round(r.ttft_s(), 6),
        }, r.first_token_pc)

    @contextmanager
    def decode_block(self, busy_lanes: int, blocks_used: Optional[int] = None):
        """Time one decode block (device scan + token readback — the
        readback is a real barrier, so this is true decode wall-clock)
        and sample batch occupancy, time-weighted by the block.  In
        paged mode `blocks_used` rides along: the LANE gauge saturates
        at `slots` long before memory does, so the block-level sample
        is the occupancy signal the autoscaler actually needs."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._decode_s += dt
            self._occ.append((busy_lanes, dt))
            em.SERVING_DECODE_TIME.inc(amount=dt)
            em.SERVING_BATCH_OCCUPANCY.set(busy_lanes)
            if blocks_used is not None:
                self._blocks_occ.append((blocks_used, dt))
                self._blocks_peak = max(self._blocks_peak, blocks_used)
                em.SERVING_KV_BLOCKS_USED.set(blocks_used)

    def request_finished(self, index: int, result: Any, step: int) -> None:
        """Request complete (EOS or budget): close the lifecycle, feed
        the histograms, and land the span tree in the tracer."""
        r = self._reqs.pop(index)
        r.finished_pc = time.perf_counter()
        r.tokens = len(result.tokens)
        r.accepted_drafts = result.accepted_drafts
        r.proposed_drafts = result.proposed_drafts
        r.finished_at_step = step
        if r.first_token_pc is None:  # defensive: activation always ran
            r.first_token_pc = r.finished_pc
        em.SERVING_REQUEST_LATENCY.observe(r.e2e_latency_s())
        em.SERVING_REQUESTS.inc()
        em.SERVING_TOKENS.inc(amount=r.tokens)
        if self._paged_kernel:
            # paged runs only: which read path served this request
            em.SERVING_PAGED_KERNEL_REQUESTS.inc(
                {"kernel": self._paged_kernel})
        tpot = r.tpot_s()
        if tpot is not None:
            em.SERVING_TPOT.observe(tpot)
        if self._spec:
            labels = {"path": "serve_loop"}
            em.SERVING_ACCEPTED_DRAFTS.inc(labels, r.accepted_drafts)
            em.SERVING_PROPOSED_DRAFTS.inc(labels, r.proposed_drafts)
        self._done.append(r)
        self._rrecord(index, "finished", {
            "tokens": r.tokens, "slot": r.slot,
            "e2e_s": round(r.e2e_latency_s(), 6),
        }, r.finished_pc)
        self.tracer.record(self._request_span(r))

    # ------------------------------------------------------------- spans
    def _request_span(self, r: _RequestTimeline) -> Span:
        """Assemble the finished request's span tree: queued / prefill
        (segment children) / decode under one root.  Every wall_start
        derives from the same clock anchor and every phase boundary is
        a shared perf_counter reading, so children nest inside their
        parents exactly."""
        def child(name: str, pc: float, dur: float, parent: Span,
                  attrs: Optional[Dict[str, Any]] = None) -> Span:
            sp = Span(name=name, start=pc, wall_start=self._wall(pc),
                      attrs=dict(attrs or {}), duration=max(0.0, dur),
                      parent=parent, thread_id=_LANE_BASE + r.index,
                      category="serving")
            parent.children.append(sp)
            return sp

        root = Span(
            name="serve_request", start=r.queued_pc,
            wall_start=self._wall(r.queued_pc),
            attrs={
                "request": r.index, "slot": r.slot, "tokens": r.tokens,
                "admitted_at_step": r.admitted_at_step,
                "finished_at_step": r.finished_at_step,
                "accepted_drafts": r.accepted_drafts,
                "proposed_drafts": r.proposed_drafts,
            },
            duration=r.e2e_latency_s(), thread_id=_LANE_BASE + r.index,
            category="serving",
        )
        child("queued", r.queued_pc, r.queue_wait_s(), root)
        prefill = child("prefill", r.admitted_pc, r.ttft_s(), root,
                        {"segments": len(r.segments)})
        for pc, dur, t0, t1 in r.segments:
            child("prefill_segment", pc, dur, prefill,
                  {"token_start": t0, "token_end": t1})
        child("decode", r.first_token_pc,
              r.finished_pc - r.first_token_pc, root,
              {"tokens": r.tokens})
        return root

    # --------------------------------------------------------- aggregate
    def loop_finished(self) -> None:
        """The serve loop exited: idle the occupancy gauge (a scrape of
        a quiescent process must read 0, not the last block's lane
        count) and sample the HBM high watermark.  serve_loop calls
        this on EVERY exit — with or without return_stats — so the
        gauge families stay honest for plain callers; idempotent, and
        finalize() reuses the sample."""
        if self._hbm is not None:
            return
        em.SERVING_BATCH_OCCUPANCY.set(0)
        em.SERVING_KV_BLOCKS_USED.set(0)
        em.SERVING_STEP_DECODE_ROWS.set(0)
        em.SERVING_STEP_PREFILL_TOKENS.set(0)
        self._hbm = _hbm_peaks(self._device)
        for dev, peak in self._hbm.items():
            em.SERVING_HBM_PEAK.set(peak, {"device": dev})

    def finalize(self) -> ServeStats:
        """Aggregate everything observed into a ServeStats (the HBM
        high-watermark sample comes from loop_finished, taken here if
        the loop didn't already)."""
        self.loop_finished()
        wall = (time.perf_counter() - self._started_pc
                if self._started_pc is not None else 0.0)
        done = sorted(self._done, key=lambda r: r.index)
        total_tokens = sum(r.tokens for r in done)
        tpots = [r.tpot_s() for r in done]
        tpots = [t for t in tpots if t is not None]
        occ_time = sum(dt for _, dt in self._occ)
        blk_time = sum(dt for _, dt in self._blocks_occ)
        accepted = sum(r.accepted_drafts for r in done)
        proposed = sum(r.proposed_drafts for r in done)
        hbm = dict(self._hbm or {})
        return ServeStats(
            requests=len(done),
            slots=self._slots,
            speculative=self._spec,
            scheduler=self._scheduler,
            paged=self._pool_total > 0,
            paged_kernel=self._paged_kernel,
            kv_block_size=self._pool_block_size,
            kv_blocks_total=self._pool_total,
            kv_blocks_peak_used=self._blocks_peak,
            kv_block_occupancy_mean=(
                sum(b * dt for b, dt in self._blocks_occ) / blk_time
                if blk_time > 0 else 0.0),
            cow_copies=self._cow,
            prefix_block_hits=self._prefix_hits,
            admissions_blocked_on_memory=self._adm_blocked,
            window_evicted_blocks=self._window_evicted,
            wasted_lane_steps=self._wasted_lane_steps,
            fused_prefill_tokens=self._fused_prefill_tokens,
            preemptions=self._preemptions,
            handoff_exports=self._handoff_exports,
            handoff_adoptions=self._handoff_adoptions,
            total_tokens=total_tokens,
            wall_time_s=wall,
            tokens_per_sec=total_tokens / wall if wall > 0 else 0.0,
            queue_wait_mean_s=_mean([r.queue_wait_s() for r in done]),
            queue_wait_max_s=max(
                [r.queue_wait_s() for r in done], default=0.0),
            ttft_mean_s=_mean([r.ttft_s() for r in done]),
            ttft_max_s=max([r.ttft_s() for r in done], default=0.0),
            tpot_mean_s=_mean(tpots) if tpots else None,
            e2e_latency_mean_s=_mean([r.e2e_latency_s() for r in done]),
            e2e_latency_max_s=max(
                [r.e2e_latency_s() for r in done], default=0.0),
            prefill_time_s=self._prefill_s,
            decode_time_s=self._decode_s,
            occupancy_mean=(
                sum(b * dt for b, dt in self._occ) / occ_time
                if occ_time > 0 else 0.0),
            occupancy_max=max([b for b, _ in self._occ], default=0),
            accepted_drafts=accepted,
            proposed_drafts=proposed,
            acceptance_rate=(accepted / proposed if proposed else None),
            hbm_peak_bytes=hbm,
            per_request=[{
                "request": r.index,
                "slot": r.slot,
                "tokens": r.tokens,
                "queue_wait_s": r.queue_wait_s(),
                "ttft_s": r.ttft_s(),
                "tpot_s": r.tpot_s(),
                "e2e_latency_s": r.e2e_latency_s(),
                "prefill_s": r.prefill_s,
                "accepted_drafts": r.accepted_drafts,
                "proposed_drafts": r.proposed_drafts,
            } for r in done],
        )


def _hbm_peaks(device: Optional[torch.device]) -> Dict[str, int]:
    """{card: peak bytes allocated} for the loop's CUDA device (torch's
    caching allocator: the process peak, never reset here); {} on the
    CPU, as JAX's profiler reports no memory stats there."""
    if device is None or device.type != "cuda":
        return {}
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return {str(device): int(torch.cuda.max_memory_allocated(device))}
