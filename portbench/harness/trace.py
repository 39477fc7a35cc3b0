"""The traced run's reading of torch.profiler.

`traced` runs a piece of work under the profiler (CPU and CUDA
activities) and reduces what it recorded to:

  - busy_s: the union of the intervals in which an operation (kernel,
    copy or fill) ran on the device;
  - window_s: the host clock's length of the traced work;
  - by_kernel: device seconds by kernel name;
  - by_class: device seconds by kernel class (portbench/kernels/*.py
    name patterns; the rest is "other");
  - by_range: device seconds of the operations inside each named
    record_function range (the profiler marks each range's interval on
    the device's timeline);
  - idle_gaps: the longest stretches with nothing on the device, summed
    by the host operation that was running at each gap's middle.

The device-time split by class follows chip_smoke._kernel_class's idea,
with the name patterns read from the kernel class files.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch


def _events(prof) -> List[Tuple[str, bool, int, int]]:
    """(name, on_device, start_ns, end_ns) of every recorded event."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, int(e.start_ns()),
             int(e.start_ns() + e.duration_ns()))
            for e in prof.profiler.kineto_results.events()]


def union_ns(intervals: Sequence[Tuple[int, int]]) -> int:
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def classify(name: str, classes: Dict[str, Sequence[str]]) -> str:
    for cls, patterns in classes.items():
        if any(p in name for p in patterns):
            return cls
    return "other"


class Reading:
    def __init__(self):
        self.busy_s = 0.0
        self.window_s = 0.0
        self.by_kernel: Dict[str, float] = {}
        self.by_class: Dict[str, float] = {}
        self.by_range: Dict[str, float] = {}
        self.idle_gaps: List[List] = []
        self.seconds: dict = {}      # the reading's own cost


def reduce(events, window_s: float, classes: Dict[str, Sequence[str]],
           ranges: Sequence[str] = (), top_gaps: int = 2000) -> Reading:
    r = Reading()
    r.window_s = window_s
    # a record_function range is marked on the device's timeline under
    # its host name: such marks are no device work
    host_names = {name for name, on_dev, _, _ in events if not on_dev}
    marks = {k: [] for k in ranges}
    dev_ops, host = [], []
    for name, on_dev, st, en in events:
        if not on_dev:
            host.append((st, en, name))
        elif name in host_names:
            if name in marks:
                marks[name].append((st, en))
        else:
            dev_ops.append((st, en, name))
    r.busy_s = union_ns([(s, e) for s, e, _ in dev_ops]) / 1e9
    for s, e, name in dev_ops:
        r.by_kernel[name] = r.by_kernel.get(name, 0.0) + (e - s) / 1e9
    for name, sec in r.by_kernel.items():
        cls = classify(name, classes)
        r.by_class[cls] = r.by_class.get(cls, 0.0) + sec
    for label, iv in marks.items():
        iv.sort()
        starts = [a for a, _ in iv]
        total = 0
        for s, e, _ in dev_ops:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and iv[i][1] >= e:
                total += e - s
        r.by_range[label] = total / 1e9
    # idle gaps between consecutive device operations, labelled by the
    # innermost host event running at the gap's middle
    ops = sorted((s, e) for s, e, _ in dev_ops)
    gaps, reach = [], None
    for s, e in ops:
        if reach is not None and s > reach:
            gaps.append((s - reach, reach, s))
        reach = e if reach is None else max(reach, e)
    gaps.sort(reverse=True)
    host.sort()
    hstarts = [h[0] for h in host]
    by_host: Dict[str, float] = {}
    for length, a, b in gaps[:top_gaps]:
        mid = (a + b) // 2
        label = "no host event"
        i = bisect.bisect_right(hstarts, mid) - 1
        best = None
        for j in range(i, max(-1, i - 300), -1):
            hs, he, hn = host[j]
            if he >= mid and (best is None or he - hs < best):
                best, label = he - hs, hn
        by_host[label] = by_host.get(label, 0.0) + length / 1e9
    r.idle_gaps = [[k, v] for k, v in
                   sorted(by_host.items(), key=lambda kv: -kv[1])[:10]]
    return r


def traced(fn: Callable[[], object], classes: Dict[str, Sequence[str]],
           ranges: Sequence[str] = ()) -> Tuple[object, Reading]:
    """fn()'s result and the reading of its trace; the work is synchronized
    before the window closes."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    events = _events(prof)
    t2 = time.perf_counter()
    r = reduce(events, window_s, classes, ranges)
    r.seconds = dict(stop=t1 - t0 - window_s, events=t2 - t1,
                     reduce=time.perf_counter() - t2, count=len(events))
    return out, r


def record_ranges(patches):
    """Wrap (module, attribute, label) functions in record_function
    ranges of that label; returns the undo."""
    saved = []
    for mod, name, label in patches:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _fn(*a, **kw)

        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return undo


def breakdown(r: Reading) -> dict:
    return {"device_ops": [[k, v] for k, v in sorted(
        r.by_kernel.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": r.idle_gaps}
