"""The traced run: torch.profiler over the window, reduced to what the
per-layer metrics read.

Device time is the union of the kernel spans (kernels of two streams that
overlap count once), never a sum of nested ranges. The summary keeps each
kernel's name, start and duration, the busy seconds, the most expensive
device operations, and the longest idle gaps of the device, each named by
the innermost host operation that was running when the gap began.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

import torch


@dataclass
class Trace:
    kernels: list = field(default_factory=list)   # (name, start_us, dur_us), by start
    busy_s: float = 0.0
    window_s: float = 0.0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def device_seconds(self, names) -> tuple:
        """→ (launches, seconds) of the kernels whose name contains one of
        ``names``."""
        hits = [d for n, _, d in self.kernels if any(k in n for k in names)]
        return len(hits), sum(hits) * 1e-6


def _events(prof):
    """(name, is_device, start_us, dur_us) of every event but the user
    annotations (ranges such as a ``record_function`` span, which the trace
    also shows on the device's timeline), from the raw Kineto results
    (building FunctionEvent trees is far slower)."""
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    out = []
    if raw is not None:
        # the device's copies of host ranges carry the host range's name
        ranges = {e.name() for e in raw if e.is_user_annotation()}
        for e in raw:
            dev = e.device_type() == torch.autograd.DeviceType.CUDA
            if e.is_user_annotation() or (dev and e.name() in ranges):
                continue
            out.append((e.name(), dev, e.start_ns() / 1e3, e.duration_ns() / 1e3))
        return out
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        dev = e.device_type == torch.autograd.DeviceType.CUDA
        out.append((e.name, dev, e.time_range.start, e.time_range.end - e.time_range.start))
    return out


def summarize(prof, window_s: float) -> Trace:
    events = _events(prof)
    dev = sorted((s, d, n) for n, is_dev, s, d in events if is_dev and d > 0)
    host = sorted((s, s + d, n) for n, is_dev, s, d in events if not is_dev and d > 0)
    tr = Trace(window_s=window_s)
    tr.kernels = [(n, s, d) for s, d, n in dev]
    busy, gaps = 0.0, []
    end = None
    for s, d, n in dev:
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, end))
            busy += d
            end = s + d
        elif s + d > end:
            busy += s + d - end
            end = s + d
    tr.busy_s = busy * 1e-6
    by_name: dict = {}
    for s, d, n in dev:
        by_name[n] = by_name.get(n, 0.0) + d * 1e-6
    tr.device_ops = sorted(([n[:120], v] for n, v in by_name.items()), key=lambda x: -x[1])[:10]
    starts = [h[0] for h in host]
    named = []
    for length, at in sorted(gaps, reverse=True)[:10]:
        i = bisect.bisect_right(starts, at) - 1
        label = "no host operation"
        # the innermost host operation that covers the gap's start
        best = None
        j = i
        while j >= 0 and j > i - 2000:
            s, e, n = host[j]
            if e >= at and (best is None or s > best[0]):
                best = (s, n)
            j -= 1
        if best is not None:
            label = best[1]
        named.append([label[:120], length * 1e-6])
    tr.idle_gaps = named
    return tr


@contextlib.contextmanager
def profiled(enabled: bool):
    """torch.profiler over CPU and CUDA when ``enabled``; yields the
    profiler or None."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False) as p:
        yield p
