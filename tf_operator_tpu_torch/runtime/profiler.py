"""Profiling: per-step metrics, goodput/MFU accounting and device traces.

The port of tf_operator_tpu/runtime/profiler.py.  `StepProfile`,
`GoodputTracker` and the metrics line are the JAX package's host-side code
(copied: that module imports jax at its top).  Device traces come from
`torch.profiler` where the JAX package uses `jax.profiler`: a Chrome trace
per window under `trace_dir`, with each train step marked by
`annotate_step`.  `device_memory_stats` reads `torch.cuda.memory_stats`.

Pieces:
  - `StepProfile`: ring-buffer of per-step wall times -> steps/sec, p50/p99.
  - `annotate_step(n)`: a record_function range so device traces align to
    steps.
  - `GoodputTracker`: splits wall-clock into productive step time vs
    checkpoint-save, resume-replay, and idle time, plus an MFU estimate
    from a caller-supplied FLOPs-per-step.
  - `Profiler`: programmatic trace capture (start/stop or N-step window),
    plus a metrics-line emitter the runner ships to stdout.
"""
from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterator, Optional

import torch


def annotate_step(step: int):
    """Context manager marking one train step in the device trace."""
    return torch.profiler.record_function(f"train_step_{step}")


@dataclass
class StepProfile:
    """Per-step wall-time stats over a sliding window.

    The window is a deque(maxlen=window): appending past capacity drops
    the oldest in O(1), where a list + pop(0) shifted the whole window
    every step in the hot loop."""

    window: int = 200
    _times: Deque[float] = field(default_factory=deque)
    _last: Optional[float] = None

    def __post_init__(self) -> None:
        self._times = deque(self._times, maxlen=self.window)

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    def reset(self) -> None:
        self._times.clear()
        self._last = None

    @property
    def steps_recorded(self) -> int:
        return len(self._times)

    def steps_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)

    def percentile(self, q: float) -> float:
        """q-th percentile step time in seconds (q in [0, 100])."""
        if not self._times:
            return 0.0
        xs = sorted(self._times)
        idx = min(len(xs) - 1, max(0, math.ceil(q / 100.0 * len(xs)) - 1))
        return xs[idx]

    def summary(self, batch_size: Optional[int] = None) -> Dict[str, float]:
        s: Dict[str, float] = {
            "steps_per_sec": self.steps_per_sec(),
            "step_time_p50_ms": self.percentile(50) * 1e3,
            "step_time_p99_ms": self.percentile(99) * 1e3,
        }
        if batch_size is not None:
            s["examples_per_sec"] = self.steps_per_sec() * batch_size
        return s


class GoodputTracker:
    """Wall-clock accounting: productive vs checkpoint vs replay vs idle.

    "Goodput" is the fraction of elapsed wall-clock spent making forward
    progress (running train steps). The rest is attributed to
    checkpoint-save stalls, resume-replay (restoring state after a
    recreation), or idle (input pipeline, host callbacks, anything
    unaccounted). The training loop (runtime/loop.py) owns the exact
    boundaries — it wraps restore and save calls in the context managers
    below — so the split is measured, not inferred.

    MFU: with a caller-supplied `flops_per_step` (model FLOPs, not
    hardware FLOPs) and the accelerator's `peak_flops_per_sec`, `mfu()`
    reports achieved-model-FLOPs / peak over total wall-clock — the
    standard Model FLOPs Utilization definition, which charges every
    non-step second against utilization."""

    def __init__(
        self,
        flops_per_step: Optional[float] = None,
        peak_flops_per_sec: Optional[float] = None,
    ) -> None:
        self.flops_per_step = flops_per_step
        self.peak_flops_per_sec = peak_flops_per_sec
        self.productive_time = 0.0
        self.checkpoint_time = 0.0
        self.replay_time = 0.0
        self.steps = 0
        self._start: Optional[float] = None
        self._end: Optional[float] = None

    # ------------------------------------------------------------ recording
    def start(self) -> None:
        """Start the wall clock (idempotent; note_* auto-start). Starting
        again after stop() resumes the clock, excluding the paused gap —
        a profiler reused across run_training sessions must not charge
        the time between sessions as idle."""
        now = time.perf_counter()
        if self._start is None:
            self._start = now
        elif self._end is not None:
            self._start += now - self._end
        self._end = None

    def stop(self) -> None:
        """Freeze the wall clock (end of the training session)."""
        if self._start is not None and self._end is None:
            self._end = time.perf_counter()

    def note_productive(self, duration: float, steps: int = 1) -> None:
        self.start()
        self.productive_time += duration
        self.steps += steps

    @contextmanager
    def checkpoint_save(self) -> Iterator[None]:
        """Wrap a (blocking portion of a) checkpoint save."""
        self.start()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.checkpoint_time += time.perf_counter() - t0

    @contextmanager
    def resume_replay(self) -> Iterator[None]:
        """Wrap checkpoint-restore / replay work done to resume a run."""
        self.start()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.replay_time += time.perf_counter() - t0

    # ------------------------------------------------------------- derived
    def wall_time(self) -> float:
        if self._start is None:
            return 0.0
        return (self._end or time.perf_counter()) - self._start

    def goodput(self) -> float:
        wall = self.wall_time()
        return self.productive_time / wall if wall > 0 else 0.0

    def mfu(self) -> Optional[float]:
        """Model FLOPs Utilization over total wall-clock; None until both
        flops_per_step and peak_flops_per_sec are known and a step ran."""
        wall = self.wall_time()
        if (
            self.flops_per_step is None
            or not self.peak_flops_per_sec
            or self.steps == 0
            or wall <= 0
        ):
            return None
        return (self.flops_per_step * self.steps / wall) / self.peak_flops_per_sec

    def summary(self) -> Dict[str, float]:
        wall = self.wall_time()
        if wall <= 0:
            return {}
        accounted = self.productive_time + self.checkpoint_time + self.replay_time
        s = {
            "wall_time_s": wall,
            "goodput": self.productive_time / wall,
            "productive_fraction": self.productive_time / wall,
            "checkpoint_fraction": self.checkpoint_time / wall,
            "replay_fraction": self.replay_time / wall,
            "idle_fraction": max(0.0, (wall - accounted) / wall),
        }
        mfu = self.mfu()
        if mfu is not None:
            s["mfu"] = mfu
        return s


def _json_safe(v):
    """JSON scalars only: tensors -> float, non-finite floats -> None
    (bare NaN/Inf is invalid JSON and breaks scrapers)."""
    if hasattr(v, "item"):
        v = float(v)
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


class Profiler:
    """Programmatic torch.profiler capture + metrics emission.

    `trace_dir` enables trace capture (CPU activity, and the card's when
    there is one) into `trace_dir/trace_<pid>_<n>.json`; without it the
    profiler still tracks step stats (a perf_counter read per step)."""

    def __init__(
        self,
        trace_dir: Optional[str] = None,
        batch_size: Optional[int] = None,
        window: int = 200,
        trace_start_step: int = 10,
        trace_num_steps: int = 20,
        flops_per_step: Optional[float] = None,
        peak_flops_per_sec: Optional[float] = None,
    ) -> None:
        self.trace_dir = trace_dir
        self.batch_size = batch_size
        self.steps = StepProfile(window=window)
        self.goodput = GoodputTracker(
            flops_per_step=flops_per_step,
            peak_flops_per_sec=peak_flops_per_sec,
        )
        self.trace_start_step = trace_start_step
        self.trace_num_steps = trace_num_steps
        self._prof: Optional[torch.profiler.profile] = None
        self._traces = 0
        self._trace_started_at: Optional[int] = None
        self._trace_done = False

    @property
    def _tracing(self) -> bool:
        return self._prof is not None

    # ------------------------------------------------------------- tracing
    def start_trace(self) -> None:
        if self.trace_dir and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()

    def stop_trace(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                self.trace_dir, f"trace_{os.getpid()}_{self._traces}.json"))
            self._traces += 1

    @contextmanager
    def trace_window(self) -> Iterator[None]:
        """Capture a device trace for the enclosed steps."""
        self.start_trace()
        try:
            yield
        finally:
            self.stop_trace()

    def maybe_trace(self, step: int) -> None:
        """Bounded-window capture driven by the training loop: with a
        trace_dir set, start once the step counter passes trace_start_step
        and stop after trace_num_steps, exactly once per process.  No-op
        otherwise; the loop's final stop_trace() flushes an unfinished
        window on early exit/preemption."""
        if not self.trace_dir or self._trace_done:
            return
        if not self._tracing:
            if step >= self.trace_start_step:
                self.start_trace()
                self._trace_started_at = step
        elif self._trace_started_at is None:
            # the window was opened externally (trace_window()/start_trace()
            # around the whole run): adopt the current step as its origin
            self._trace_started_at = step
        elif step >= self._trace_started_at + self.trace_num_steps:
            self.stop_trace()
            self._trace_done = True

    @contextmanager
    def step(self, n: int) -> Iterator[None]:
        """Wrap one train step: trace annotation + wall-time tick +
        productive-time attribution for the goodput split."""
        t0 = time.perf_counter()
        with annotate_step(n):
            yield
        self.steps.tick()
        self.goodput.note_productive(time.perf_counter() - t0)

    # ------------------------------------------------------------- metrics
    def summary(self) -> Dict[str, float]:
        """Step-time stats + the goodput/MFU split, one flat dict."""
        return {**self.steps.summary(self.batch_size), **self.goodput.summary()}

    def metrics_line(self, step: int, extra: Optional[Dict] = None) -> str:
        """One JSON line of progress metrics.  Non-finite floats (a NaN
        loss) serialize as null."""
        payload = {"step": step, **self.summary()}
        if extra:
            payload.update(extra)
        return json.dumps({k: _json_safe(v) for k, v in payload.items()})


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card memory use from the caching allocator: {"cuda:i":
    {"bytes_in_use": N, "peak_bytes_in_use": N, "bytes_limit": N}} — the
    peak is the allocation high watermark since process start (or the
    last torch.cuda.reset_peak_memory_stats), the limit the card's total
    memory.  {} without a card."""
    out: Dict[str, Dict[str, int]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
        }
    return out
