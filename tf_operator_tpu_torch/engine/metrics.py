"""Prometheus metrics: the port's copy of the primitives of
tf_operator_tpu/engine/metrics.py and of the 24 serving families that
models/telemetry.py feeds.

`Counter`, `Gauge` and `Histogram` (cumulative le-buckets, _sum and
_count) register in this module's own registry; `expose_all()` renders
it in the Prometheus text format and `reset_all()` clears it.  Each
family keeps the JAX package's name, type, HELP text, label names and
buckets (tests/test_torch_telemetry.py holds them equal), so one
dashboard reads either implementation.  The operator, fleet, router and
SLO families are not copied: nothing of the port feeds them.  The JAX
module imports no JAX, but the port imports nothing of the JAX package,
so it keeps this copy.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

_REGISTRY: List["Metric"] = []
_LOCK = threading.Lock()


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((labels or {}).items()))


class Metric:
    TYPE = "counter"

    def __init__(self, name: str, help_text: str) -> None:
        self.name = name
        self.help = help_text
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}
        with _LOCK:
            _REGISTRY.append(self)

    def get(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> Dict[Tuple[Tuple[str, str], ...], float]:
        """Snapshot of every label set's value (bench rows and tests that
        need the whole family, e.g. the per-verb/kind API-request tally)."""
        with _LOCK:
            return dict(self._values)

    @staticmethod
    def _escape_label_value(v: str) -> str:
        """Prometheus text-format label escaping: backslash, double quote,
        and line feed must be escaped or one bad value (e.g. a job name
        quoted inside an error-message label) corrupts the whole
        exposition."""
        return (
            str(v)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
        )

    def _render_labels(self, key) -> str:
        if not key:
            return ""
        inner = ",".join(
            f'{k}="{self._escape_label_value(v)}"' for k, v in key
        )
        return "{" + inner + "}"

    def expose(self) -> str:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.TYPE}",
        ]
        with _LOCK:  # snapshot; inc/set mutate _values in place under _LOCK
            values = dict(self._values) or {(): 0.0}
        for key, v in sorted(values.items()):
            lines.append(f"{self.name}{self._render_labels(key)} {v:g}")
        return "\n".join(lines)

    def reset(self) -> None:
        with _LOCK:
            self._values.clear()


class Counter(Metric):
    TYPE = "counter"

    def inc(self, labels: Optional[Dict[str, str]] = None, amount: float = 1.0) -> None:
        with _LOCK:
            k = _label_key(labels)
            self._values[k] = self._values.get(k, 0.0) + amount


class Gauge(Metric):
    TYPE = "gauge"

    def set(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        with _LOCK:
            self._values[_label_key(labels)] = value

    def remove(self, labels: Optional[Dict[str, str]] = None) -> None:
        """Drop one label-set's series (e.g. a replica that left the
        fleet) — without this the gauge exports its last value forever
        and per-entity label cardinality only ever grows."""
        with _LOCK:
            self._values.pop(_label_key(labels), None)


class Histogram(Metric):
    """Prometheus histogram: cumulative le-buckets + _sum + _count.
    Default buckets suit controller reconcile latencies (sub-ms to 10s)."""

    TYPE = "histogram"
    DEFAULT_BUCKETS = (
        0.001, 0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.15, 0.25, 0.35, 0.5,
        0.75, 1.0, 2.5, 5.0, 10.0,
    )

    def __init__(self, name: str, help_text: str, buckets=None) -> None:
        super().__init__(name, help_text)
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        # per label-set: [bucket counts..., +Inf count], sum
        self._obs: Dict[Tuple[Tuple[str, str], ...], list] = {}

    def observe(
        self, value: float, labels: Optional[Dict[str, str]] = None
    ) -> None:
        with _LOCK:
            k = _label_key(labels)
            if k not in self._obs:
                self._obs[k] = [[0] * (len(self.buckets) + 1), 0.0]
            counts, total = self._obs[k]
            for i, le in enumerate(self.buckets):
                if value <= le:
                    counts[i] += 1
            counts[-1] += 1  # +Inf
            self._obs[k][1] = total + value

    def count(self, labels: Optional[Dict[str, str]] = None) -> int:
        with _LOCK:
            obs = self._obs.get(_label_key(labels))
            return obs[0][-1] if obs else 0

    def percentiles(
        self, qs, labels: Optional[Dict[str, str]] = None
    ) -> Dict[float, Optional[float]]:
        """Approximate quantiles from the cumulative le-buckets: the upper
        bound of the first bucket whose count reaches the target rank
        (None when the quantile falls beyond the last finite bucket —
        prometheus histogram_quantile semantics, conservative upper
        bound).  The rank is ceil(q * total) clamped to >= 1 so it always
        names a WHOLE observation: q=0 asks for the smallest observation
        (rank 1), not "the first bucket whether or not anything landed in
        it" — the raw-rank form returned buckets[0] for q=0 even when
        that bucket was empty."""
        with _LOCK:
            obs = self._obs.get(_label_key(labels))
            counts = list(obs[0]) if obs else None
        if not counts or counts[-1] == 0:
            return {q: None for q in qs}
        total = counts[-1]
        out: Dict[float, Optional[float]] = {}
        for q in qs:
            rank = max(1, math.ceil(q * total))
            out[q] = next(
                (le for i, le in enumerate(self.buckets)
                 if counts[i] >= rank),
                None,
            )
        return out

    def expose(self) -> str:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.TYPE}",
        ]
        with _LOCK:  # snapshot: observe() mutates the counts lists in place
            snapshot = {k: (list(v[0]), v[1]) for k, v in self._obs.items()}
        for key, (counts, total) in sorted(snapshot.items()):
            base = dict(key)
            for i, le in enumerate(self.buckets):
                lk = self._render_labels(
                    _label_key({**base, "le": f"{le:g}"})
                )
                lines.append(f"{self.name}_bucket{lk} {counts[i]}")
            lk = self._render_labels(_label_key({**base, "le": "+Inf"}))
            lines.append(f"{self.name}_bucket{lk} {counts[-1]}")
            plain = self._render_labels(key)
            # full precision, not %g: a long-lived operator's sum must keep
            # advancing by sub-ms observations or rate() reads zero
            lines.append(f"{self.name}_sum{plain} {total!r}")
            lines.append(f"{self.name}_count{plain} {counts[-1]}")
        return "\n".join(lines)

    def reset(self) -> None:
        with _LOCK:
            self._obs.clear()
            self._values.clear()


def expose_all() -> str:
    # each expose() snapshots under _LOCK itself (non-reentrant lock — the
    # registry list is copied here so a concurrent Metric() init can't race
    # the iteration)
    with _LOCK:
        registry = list(_REGISTRY)
    return "\n".join(m.expose() for m in registry) + "\n"


def reset_all() -> None:
    with _LOCK:
        registry = list(_REGISTRY)
    for m in registry:
        m.reset()


PREFIX = "tpu_operator"

# --------------------------------------------------------------- serving
# Sub-ms buckets: a CPU smoke lane emits tokens in tens of microseconds
# and a decode step on the card lands around 5-50 ms.
_SERVING_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

SERVING_TTFT = Histogram(
    f"{PREFIX}_serving_ttft_seconds",
    "Time to first token: lane admission to the request's first sampled "
    "token (queue wait excluded — that is its own histogram)",
    buckets=_SERVING_LATENCY_BUCKETS,
)
SERVING_TPOT = Histogram(
    f"{PREFIX}_serving_tpot_seconds",
    "Time per output token: a finished request's decode wall-clock over "
    "its decoded tokens (first token excluded), one observation per "
    "request with >= 2 tokens",
    buckets=_SERVING_LATENCY_BUCKETS,
)
SERVING_QUEUE_WAIT = Histogram(
    f"{PREFIX}_serving_queue_wait_seconds",
    "How long a request sat queued before a decode lane was reserved "
    "for it",
    buckets=_SERVING_LATENCY_BUCKETS,
)
SERVING_REQUEST_LATENCY = Histogram(
    f"{PREFIX}_serving_request_latency_seconds",
    "End-to-end request latency: enqueue to final token (queue wait + "
    "prefill + decode)",
    buckets=_SERVING_LATENCY_BUCKETS,
)
SERVING_REQUESTS = Counter(
    f"{PREFIX}_serving_requests_total",
    "Requests finished by the serving loop",
)
SERVING_TOKENS = Counter(
    f"{PREFIX}_serving_tokens_total",
    "Tokens emitted to finished requests (EOS included when hit)",
)
SERVING_PREFILL_TIME = Counter(
    f"{PREFIX}_serving_prefill_seconds_total",
    "Wall-clock spent prefilling prompts into lane caches (the other "
    "half of the prefill-vs-decode split)",
)
SERVING_DECODE_TIME = Counter(
    f"{PREFIX}_serving_decode_seconds_total",
    "Wall-clock spent in decode blocks (device step + token readback)",
)
SERVING_BATCH_OCCUPANCY = Gauge(
    f"{PREFIX}_serving_batch_occupancy",
    "Decode lanes occupied by live requests, sampled at each decode "
    "block (bounded by the serve loop's slots)",
)
SERVING_ACCEPTED_DRAFTS = Counter(
    f"{PREFIX}_serving_accepted_drafts_total",
    "Speculative draft tokens accepted by target verification "
    "(accepted/proposed is the acceptance rate); labeled by path: "
    "serve_loop or speculative_generate",
)
SERVING_PROPOSED_DRAFTS = Counter(
    f"{PREFIX}_serving_proposed_drafts_total",
    "Speculative draft tokens proposed to target verification; labeled "
    "by path: serve_loop or speculative_generate",
)
SERVING_HBM_PEAK = Gauge(
    f"{PREFIX}_serving_hbm_peak_bytes",
    "Per-device HBM high watermark sampled at the end of a serve_loop "
    "run (runtime/profiler.device_memory_stats); on backends without "
    "memory stats (CPU) no device-labeled sample is ever set and the "
    "family exposes only the default unlabeled 0",
)
# Paged-KV families: the *_kv_blocks_total gauge is a CAPACITY (the
# blocks the pool was built with), so used/total is the block-occupancy
# ratio.
SERVING_KV_BLOCKS_TOTAL = Gauge(
    f"{PREFIX}_serving_kv_blocks_total",
    "KV block-pool capacity (usable blocks; scratch excluded) of the "
    "serving process's paged cache — a capacity level, set at serve "
    "start; 0 means dense (unpaged) serving",
)
SERVING_KV_BLOCKS_USED = Gauge(
    f"{PREFIX}_serving_kv_blocks_used",
    "KV blocks currently allocated to live lanes and shared prefixes, "
    "sampled at every decode block — used/total is the block-level "
    "occupancy the autoscaler should scale on (lane occupancy "
    "saturates at `slots` long before memory does)",
)
SERVING_KV_BLOCK_COW_COPIES = Counter(
    f"{PREFIX}_serving_kv_block_cow_copies_total",
    "Copy-on-write block copies at admission: a shared prefix whose "
    "length is not a block multiple copies exactly its boundary block "
    "per lane (one block, not the dense path's whole-cache copy)",
)
SERVING_PREFIX_BLOCK_HITS = Counter(
    f"{PREFIX}_serving_prefix_block_hits_total",
    "Shared-prefix blocks reused by reference at admission instead of "
    "being re-prefilled or copied — each hit is one block of KV the "
    "admission did not have to produce",
)
SERVING_ADMISSION_BLOCKED = Counter(
    f"{PREFIX}_serving_admission_blocked_on_memory_total",
    "Admissions deferred by the memory gate: a decode lane was free and "
    "a request was queued, but the block pool could not cover the "
    "request's worst case — the request waits instead of OOMing "
    "(sampled once per serve-loop iteration while blocked)",
)
SERVING_PAGED_KERNEL_REQUESTS = Counter(
    f"{PREFIX}_serving_paged_kernel_requests_total",
    "Paged requests finished, labeled by the read path that served "
    "them (kernel=pallas: the block-indexed paged-attention kernel, "
    "models/paged_attention.py; kernel=gather: the table-gathered "
    "linear-view oracle) — the pallas/gather ratio is the "
    "fast-path-adoption signal after a rollout",
)
# Sliding-window rotation, the continuous scheduler's step mix, and the
# disaggregated prefill/decode handoff.
SERVING_KV_WINDOW_EVICTED = Counter(
    f"{PREFIX}_serving_kv_window_evicted_blocks_total",
    "KV block epochs retired by sliding-window rotation: a windowed "
    "lane's modular table wrapped past a block's positions — private "
    "blocks are reused in place, shared prefix blocks are dereferenced "
    "(and copied only while still partially visible); compare with "
    "the CoW-copy rate to see window pressure vs prefix-boundary cost",
)
SERVING_STEP_DECODE_ROWS = Gauge(
    f"{PREFIX}_serving_step_decode_rows",
    "Decode lanes advanced by the most recent serving dispatch (the "
    "ragged step's decode side; 0 between runs) — under the continuous "
    "scheduler this is the iteration batch the admission gate filled, "
    "under the slot loop it equals the block's busy-lane count",
)
SERVING_STEP_PREFILL_TOKENS = Gauge(
    f"{PREFIX}_serving_step_prefill_tokens",
    "Prefill tokens fused into the most recent serving dispatch beside "
    "its decode rows (continuous scheduler, paged mode: one admitted "
    "prompt's segment rides the same device step; 0 for slot-loop and "
    "unfused dispatches) — the fused-prefill ratio vs "
    "serving_step_decode_rows shows how much prefill the fleet hides "
    "inside decode steps",
)
SERVING_LANE_WASTED_STEPS = Counter(
    f"{PREFIX}_serving_lane_wasted_steps_total",
    "Lane-steps computed for already-finished lanes: the slot loop "
    "runs every lane to the steps_per_sync block edge and discards the "
    "post-EOS tail; the continuous scheduler freezes lanes on-device "
    "mid-block, leaving only the freeze-to-edge residue — a shrinking "
    "rate here is the iteration scheduler paying off",
)
SERVING_HANDOFF_BLOCKS = Counter(
    f"{PREFIX}_serving_handoff_blocks_total",
    "KV blocks crossing the prefill→decode handoff by phase: "
    "exported/elided count the sender's wire composition (elided = "
    "shared-prefix blocks referenced by content hash, shipped "
    "earlier), adopted/deduped count the receiver's pool composition "
    "(deduped = hash hit, an incref instead of an alloc+write) — "
    "elided/exported and deduped/adopted are the hot-prefix transfer "
    "savings",
)
SERVING_HANDOFF_DURATION = Histogram(
    f"{PREFIX}_serving_handoff_duration_seconds",
    "Wall-clock of one lane's KV handoff half, by side: export "
    "(device_get + hashing + wire form on the prefill replica) and "
    "adopt (alloc + one jitted scatter on the decode replica) — the "
    "handoff's latency contribution to disaggregated TTFT; compare "
    "p99 against serving_ttft_seconds to see whether the wire or the "
    "compute dominates the split's overhead",
    buckets=(.0005, .001, .0025, .005, .01, .025, .05, .1, .25, .5,
             1.0, 2.5),
)
