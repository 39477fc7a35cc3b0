"""Span tracing: the port's copy of tf_operator_tpu/engine/tracing.py.

A thread-safe `Tracer` of nested spans (name, attrs, start, duration,
parent).  The serving telemetry (models/telemetry.py) assembles each
request's span tree by hand and lands it with `Tracer.record()`; the
finished roots export as Chrome trace-event JSON (`to_chrome_trace()`,
`dump()`), loadable in chrome://tracing or Perfetto.

Spans nest via a thread-local stack (`Tracer.span()`); finished ROOT
spans land in a bounded ring buffer, so a long-lived process keeps the
most recent traces without unbounded growth.  The code is the JAX
package's, line for line (that module imports no JAX, but the port
imports nothing of the JAX package); tests/test_torch_telemetry.py holds
the two exports equal for the same span tree.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional


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


_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    """The process-global tracer (the analogue of the metrics registry):
    engines default to it, the health server serves it, --trace-dump
    persists it."""
    return _GLOBAL
