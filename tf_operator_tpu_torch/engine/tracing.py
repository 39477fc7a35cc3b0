"""Span tracing: the port's copy of tf_operator_tpu/engine/tracing.py,
plus device-timed phase spans.

A thread-safe `Tracer` of nested spans (name, attrs, start, duration,
parent).  The serving telemetry (models/telemetry.py) assembles each
request's span tree by hand and lands it with `Tracer.record()`; the
finished roots export as Chrome trace-event JSON (`to_chrome_trace()`,
`dump()`), loadable in chrome://tracing or Perfetto.

Spans nest via a thread-local stack (`Tracer.span()`); finished ROOT
spans land in a bounded ring buffer, so a long-lived process keeps the
most recent traces without unbounded growth.  That code is the JAX
package's, line for line (that module imports no JAX, but the port
imports nothing of the JAX package); tests/test_torch_telemetry.py holds
the two exports equal for the same span tree.

Phase spans are the port's own: `Tracer.train_step()` and
`Tracer.phase()` mark the phases of a training step (the step factories,
`TrainState.apply_gradients`, `parallel/dp.finish_step`), category
"train".  They are on only while torch.profiler captures
(`torch.autograd._profiler_enabled()`: the benchmark's traced run, an
operator's `runtime/profiler.Profiler` window); off, a phase is one call
and one branch.  On, each records its host start and duration from
`time.time_ns()` (the clock of the profiler's events), a
`record_function` range of its name in the device trace, and on CUDA a
pair of timing events on the current stream, whose elapsed time is the
phase's device interval (idle time inside it included; on the CPU the
host interval).  `Tracer.backward_part()` times the part of a phase
that backward runs, up to the moment a tensor's gradient arrives.
Finished phases fold into per-name totals (`phase_totals()`: count,
host and device seconds) once their events complete; the totals cover
the latest capture only, which starts at the first phase opened with the
profiler on after one opened with it off (two captures with no phase
between them count as one).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import torch

# a phase span while torch.profiler does not capture: shared, so that an
# untraced step allocates nothing for its spans
_OFF = nullcontext()


@dataclass
class Span:
    """One timed region. `duration` stays None until the span finishes.

    `category` becomes the Chrome trace event's `cat` (the trace viewer's
    filter axis): reconcile spans and serving-request spans share one
    export but remain separable.  `thread_id` is the trace LANE, not
    necessarily an OS thread — serving telemetry assigns one virtual lane
    per request so overlapping in-flight requests render as parallel
    tracks instead of a single overdrawn row."""

    name: str
    start: float  # perf_counter seconds (duration arithmetic)
    wall_start: float  # epoch seconds (trace-viewer timestamps)
    attrs: Dict[str, Any] = field(default_factory=dict)
    duration: Optional[float] = None
    parent: Optional["Span"] = None
    children: List["Span"] = field(default_factory=list)
    thread_id: int = 0
    category: str = "reconcile"
    # a phase span's device seconds, once its events have completed
    device_duration: Optional[float] = None
    # a phase span's clocks until it is folded into the totals
    timing: Optional["_Timing"] = field(default=None, repr=False,
                                        compare=False)

    def walk(self) -> Iterator["Span"]:
        """Depth-first iteration over this span and all descendants."""
        yield self
        for child in self.children:
            yield from child.walk()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "start": self.wall_start,
            "duration": self.duration,
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }


@dataclass
class PhaseTotal:
    """One phase name's sum over the latest capture."""

    count: int = 0
    host_s: float = 0.0
    device_s: float = 0.0


class _Timing:
    """A phase span's clocks: its host start (Unix ns), its CUDA events
    (None on the CPU), the capture it belongs to, and, on a root, the
    backward parts its gradient hooks closed: (name, since, end ns,
    end event)."""

    __slots__ = ("start_ns", "cuda", "begin", "end", "capture", "parts")

    def __init__(self, start_ns: int, cuda: bool, capture: int) -> None:
        self.start_ns = start_ns
        self.cuda = cuda
        self.begin = _event() if cuda else None
        self.end = None
        self.capture = capture
        self.parts: List[tuple] = []


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Tracer:
    """Thread-safe nested-span tracer.

    `span()` is the single entry point: it pushes onto the calling
    thread's stack (so spans opened inside an open span become children),
    and on exit either attaches to the parent or — for roots — lands in
    the shared ring buffer of finished traces. Passing `histogram=` (an
    engine.metrics.Histogram) observes the duration with `labels=` on
    exit, which is how per-phase histograms stay in lock-step with the
    trace without double instrumentation."""

    def __init__(self, max_traces: int = 256) -> None:
        self.max_traces = max_traces
        self._finished: "deque[Span]" = deque(maxlen=max_traces)
        self._local = threading.local()
        self._lock = threading.Lock()
        # phase spans: the roots whose events are still to complete, the
        # totals of the latest capture, and which capture that is
        self._pending: "deque[Span]" = deque()
        self._totals: Dict[str, PhaseTotal] = {}
        self._capture = 0
        self._capturing = False

    # ------------------------------------------------------------- spans
    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _thread_id(self) -> int:
        # cached per thread: get_native_id() is a real syscall (gettid) and
        # spans are opened several times per sync — on hardened kernels the
        # uncached call was ~30% of reconcile CPU under profile
        tid = getattr(self._local, "tid", None)
        if tid is None:
            tid = self._local.tid = threading.get_native_id()
        return tid

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    @contextmanager
    def span(
        self,
        name: str,
        attrs: Optional[Dict[str, Any]] = None,
        histogram=None,
        labels: Optional[Dict[str, str]] = None,
    ) -> Iterator[Span]:
        stack = self._stack()
        sp = Span(
            name=name,
            start=time.perf_counter(),
            wall_start=time.time(),
            attrs=dict(attrs or {}),
            parent=stack[-1] if stack else None,
            thread_id=self._thread_id(),
        )
        stack.append(sp)
        try:
            yield sp
        finally:
            sp.duration = time.perf_counter() - sp.start
            stack.pop()
            if sp.parent is not None:
                sp.parent.children.append(sp)
            else:
                with self._lock:
                    self._finished.append(sp)
            if histogram is not None:
                histogram.observe(sp.duration, labels)

    # ------------------------------------------------------- phase spans
    def phase(self, name: str):
        """A phase span of `name` (category "train") while torch.profiler
        captures, nested under the open span; otherwise a shared context
        that records nothing."""
        if not torch.autograd._profiler_enabled():
            self._capturing = False
            return _OFF
        return self._phase(name, None, None)

    def train_step(self, step: int, batch: torch.Tensor):
        """The root phase `train_step` of one training step, with
        attributes `step` (the state's step before it) and `tokens`
        (`batch`'s elements); device-timed when `batch` is on CUDA."""
        if not torch.autograd._profiler_enabled():
            self._capturing = False
            return _OFF
        return self._phase("train_step",
                           {"step": step, "tokens": batch.numel()},
                           batch.is_cuda)

    def backward_part(self, t: torch.Tensor, name: str, since: str) -> None:
        """While a capture is on, inside a phase root: a part of phase
        `name` that starts where the root's `since` phase starts and ends
        when `t`'s gradient arrives (a hook on `t`, which may run on
        autograd's thread: it writes to the root's record only)."""
        if not torch.autograd._profiler_enabled() or not t.requires_grad:
            return
        stack = self._stack()
        if not stack or stack[0].timing is None:
            return
        timing = stack[0].timing
        parts, cuda = timing.parts, timing.cuda

        def close(grad):
            parts.append((name, since, time.time_ns(),
                          _event() if cuda else None))

        t.register_hook(close)

    @contextmanager
    def _phase(self, name: str, attrs: Optional[Dict[str, Any]],
               cuda: Optional[bool]) -> Iterator[Span]:
        if not self._capturing:
            # the first phase of a capture starts the totals afresh
            with self._lock:
                self._capture += 1
                self._totals = {}
            self._capturing = True
        stack = self._stack()
        parent = stack[-1] if stack else None
        if cuda is None:
            up = parent.timing if parent is not None else None
            cuda = up.cuda if up is not None \
                else torch.cuda.is_initialized()
        # the range takes its own clock reading somewhere inside its
        # entry: the span starts in the middle of the entry
        rf = torch.profiler.record_function(name)
        before = time.time_ns()
        rf.__enter__()
        ns = (before + time.time_ns()) // 2
        sp = Span(name=name, start=ns / 1e9, wall_start=ns / 1e9,
                  attrs=dict(attrs or {}), parent=parent,
                  thread_id=self._thread_id(), category="train")
        stack.append(sp)
        sp.timing = timing = _Timing(ns, cuda, self._capture)
        try:
            yield sp
        finally:
            if cuda:
                timing.end = _event()
            rf.__exit__(None, None, None)
            sp.duration = (time.time_ns() - ns) / 1e9
            stack.pop()
            if parent is not None:
                parent.children.append(sp)
            else:
                with self._lock:
                    self._finished.append(sp)
                    self._pending.append(sp)
                self._fold(wait=False)

    def _fold(self, wait: bool) -> None:
        """Fold finished phase roots into the totals, oldest first: those
        whose last event has completed, or all of them (`wait`)."""
        with self._lock:
            while self._pending:
                root = self._pending[0]
                end = root.timing.end
                if end is not None and not wait and not end.query():
                    return
                self._pending.popleft()
                current = root.timing.capture == self._capture
                _close_parts(root)
                for sp in root.walk():
                    tm = sp.timing
                    if tm is not None:
                        sp.timing = None
                        sp.device_duration = sp.duration if tm.end is None \
                            else _elapsed_s(tm.begin, tm.end)
                    if not current or sp.device_duration is None:
                        continue
                    tot = self._totals.setdefault(sp.name, PhaseTotal())
                    tot.count += 1
                    tot.host_s += sp.duration
                    tot.device_s += sp.device_duration

    def phase_totals(self) -> Dict[str, PhaseTotal]:
        """{name: PhaseTotal} of the phases of the latest capture, every
        finished one folded in (this waits for their events)."""
        self._fold(wait=True)
        with self._lock:
            return {k: PhaseTotal(v.count, v.host_s, v.device_s)
                    for k, v in self._totals.items()}

    def record(self, span: Span) -> None:
        """Land an externally assembled FINISHED root span in the ring
        buffer.  `span()` is the right tool for code-shaped regions; this
        is the seam for lifecycles that interleave — a serving request's
        queued/prefill/decode phases overlap other requests' phases on
        the same host thread, so a context-manager stack cannot express
        them and the caller builds the span tree itself."""
        if span.duration is None:
            raise ValueError(
                f"span {span.name!r} is unfinished (duration=None) — "
                f"record() takes completed root spans only")
        with self._lock:
            self._finished.append(span)

    # ------------------------------------------------------------ queries
    def traces(self) -> List[Span]:
        """Snapshot of finished root spans, oldest first."""
        with self._lock:
            return list(self._finished)

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()

    # ------------------------------------------------------------- export
    def to_chrome_trace(
        self, category: Optional[str] = None, limit: Optional[int] = None
    ) -> Dict[str, Any]:
        """Chrome trace-event format (`ph:"X"` complete events, micros) —
        loadable in chrome://tracing and Perfetto.

        `category` keeps only spans whose `cat` matches (reconcile vs
        serving traces share one ring but are separable; /debug/traces
        additionally merges per-job "timeline" lanes and per-request
        "request" lanes under the same axis); `limit` keeps
        only the most recent N root traces — the /debug/traces query
        filters, so a dashboard can pull \"last 5 serving traces\" without
        downloading the whole ring.  With both given, the category
        filter runs FIRST: ?category=serving&limit=5 means the newest 5
        serving traces, not \"the newest 5 traces, serving spans only\"
        (which could be empty while serving traces sit in the ring)."""
        events: List[Dict[str, Any]] = []
        pid = os.getpid()
        roots = self.traces()
        if category is not None:
            roots = [
                r for r in roots
                if any(sp.category == category for sp in r.walk())
            ]
        if limit is not None and limit >= 0:
            roots = roots[-limit:] if limit > 0 else []
        for root in roots:
            for sp in root.walk():
                if sp.duration is None:
                    continue
                if category is not None and sp.category != category:
                    continue
                events.append(
                    {
                        "name": sp.name,
                        "cat": sp.category,
                        "ph": "X",
                        "ts": sp.wall_start * 1e6,
                        "dur": sp.duration * 1e6,
                        "pid": pid,
                        "tid": sp.thread_id,
                        "args": dict(sp.attrs),
                    }
                )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_json(
        self, category: Optional[str] = None, limit: Optional[int] = None
    ) -> str:
        return json.dumps(self.to_chrome_trace(category=category, limit=limit))

    def dump(self, path: str) -> None:
        """Write the Chrome trace-event JSON to `path` (--trace-dump)."""
        with open(path, "w") as fh:
            fh.write(self.export_chrome_json())


def _elapsed_s(begin, end) -> float:
    end.synchronize()
    return begin.elapsed_time(end) / 1e3


def _close_parts(root: Span) -> None:
    """Each backward part a hook closed becomes a child span of the
    latest `since` phase that started before it: from that phase's start
    to the hook, on the host clock and between the CUDA events."""
    for name, since, end_ns, end_ev in root.timing.parts:
        owner = None
        for sp in root.walk():
            if sp.name == since and sp.timing is not None \
                    and sp.timing.start_ns <= end_ns:
                owner = sp
        if owner is None:
            continue
        duration = (end_ns - owner.timing.start_ns) / 1e9
        part = Span(name=name, start=owner.start, wall_start=owner.wall_start,
                    duration=duration, parent=owner,
                    thread_id=owner.thread_id, category="train")
        part.device_duration = duration if end_ev is None \
            else _elapsed_s(owner.timing.begin, end_ev)
        owner.children.append(part)
    root.timing.parts = []


_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer (the analogue of the metrics registry):
    engines default to it, the health server serves it, --trace-dump
    persists it."""
    return _GLOBAL
