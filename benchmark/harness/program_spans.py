"""The program's own spans on the device trace's timeline.

The port keeps a record of each span it passes through while a
torch.profiler records (``daliid_tpu_torch.utils.profiling.span_records``):
name, thread, start and end on ``time.time_ns()``, parent and a count of
the work done inside it. The profiler stamps its events on the same clock,
so the two lie on one timeline with no offset fitted to the data.

The window is ``[run.t_start + run.setup_s, + run.window_s]`` on the
``time.time()`` clock. The device is idle where no event of the trace's
device timeline (``run.tracer.kernels``: kernels, copies, fills) runs; each
idle microsecond is put down to the innermost span open at that instant on
the thread that launches the device's work, the main thread, or to no span.
Spans of other threads (the decode threads) are not used for that; their
counts and durations give rates.

Every reader here returns None, never 0 and never an error, where there is
no trace, no record (a program without spans, such as one older than them),
or no record or device event inside the window.
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field

NO_SPAN = "(no span)"


def program_records() -> list:
    """The program's span records, or [] where the program keeps none."""
    try:
        from daliid_tpu_torch.utils.profiling import span_records
    except ImportError:
        return []
    return span_records()


@dataclass
class Attribution:
    window_s: float
    idle_s: float
    by_span: dict = field(default_factory=dict)    # innermost span name -> idle seconds
    seen: set = field(default_factory=set)         # main-thread span names in the window
    records: list = field(default_factory=list)    # every thread's records in the window
    first_event_s: float = 0.0                     # window start to its first device event


def _window_ns(run) -> tuple:
    w0 = int(round((run.t_start + run.setup_s) * 1e9))
    return w0, w0 + int(round(run.window_s * 1e9))


def _busy(kernels, w0: int, w1: int) -> list:
    """The union of the device events inside [w0, w1], as sorted disjoint
    (start, end) in ns."""
    spans = sorted((int(s * 1e3), int((s + d) * 1e3)) for _, s, d in kernels)
    out = []
    for s, e in spans:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _idle(busy: list, w0: int, w1: int) -> list:
    out, at = [], w0
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < w1:
        out.append((at, w1))
    return out


def innermost(spans: list) -> list:
    """(start, end, name) of one thread's spans → sorted disjoint (start,
    end, name) pieces, each naming the innermost span open over it (the
    open span that started last); no piece where none is open."""
    events = sorted([(s, 0, i) for i, (s, e, _) in enumerate(spans)]
                    + [(e, 1, i) for i, (s, e, _) in enumerate(spans)])
    out, open_, last = [], [], None
    for t, ends, i in events:
        if open_ and t > last:
            name = spans[open_[-1]][2]
            if out and out[-1][2] == name and out[-1][1] == last:
                out[-1] = (out[-1][0], t, name)
            else:
                out.append((last, t, name))
        last = t
        if ends:
            open_.remove(i)
        else:
            open_.append(i)
    return out


def _overlap_by_name(idle: list, pieces: list) -> dict:
    """Idle ns of each piece's name, and of NO_SPAN where no piece lies."""
    starts = [p[0] for p in pieces]
    out: dict = {}
    for s, e in idle:
        covered = 0
        j = max(bisect.bisect_right(starts, s) - 1, 0)
        while j < len(pieces) and pieces[j][0] < e:
            ps, pe, name = pieces[j]
            lo, hi = max(s, ps), min(e, pe)
            if hi > lo:
                out[name] = out.get(name, 0) + hi - lo
                covered += hi - lo
            j += 1
        if e - s > covered:
            out[NO_SPAN] = out.get(NO_SPAN, 0) + e - s - covered
    return out


def attribution(run):
    """The window's device idle time by innermost main-thread span, or None
    (no trace, no records, or nothing of either inside the window). Kept on
    the run, and noted once on standard error."""
    cached = run.__dict__.get("_program_spans")
    if cached is not None:
        return cached
    tr = run.tracer
    if tr is None or not tr.kernels or run.window_s <= 0.0:
        return None
    w0, w1 = _window_ns(run)
    inside = [r for r in program_records() if r.end_ns > w0 and r.start_ns < w1]
    main = threading.main_thread().ident
    mine = [(max(r.start_ns, w0), min(r.end_ns, w1), r.name) for r in inside if r.thread == main]
    busy = _busy(tr.kernels, w0, w1)
    if not mine or not busy:
        return None
    idle = _idle(busy, w0, w1)
    by = _overlap_by_name(idle, innermost(mine))
    att = Attribution(window_s=(w1 - w0) * 1e-9, idle_s=sum(e - s for s, e in idle) * 1e-9,
                      by_span={k: v * 1e-9 for k, v in sorted(by.items())},
                      seen={m[2] for m in mine}, records=inside,
                      first_event_s=(busy[0][0] - w0) * 1e-9)
    run.__dict__["_program_spans"] = att
    run.note(f"program spans: device idle {att.idle_s!r} s of the window's {att.window_s!r} s "
             f"(its first device event at {att.first_event_s!r} s); idle by innermost "
             f"main-thread span: {att.by_span}")
    return att


def idle_pct(run, names) -> float | None:
    """Device idle time inside the spans ``names`` (each the innermost open
    on the main thread) over the window, in %; None unless one of them ran
    in the window."""
    att = attribution(run)
    if att is None or not att.seen & set(names):
        return None
    return 100.0 * sum(att.by_span.get(n, 0.0) for n in names) / att.window_s


def rate(run, name: str) -> float | None:
    """Work counted in the window's ``name`` spans (any thread, those that
    lie wholly inside it) over their summed seconds."""
    att = attribution(run)
    if att is None:
        return None
    w0, w1 = _window_ns(run)
    hits = [r for r in att.records
            if r.name == name and r.n and r.start_ns >= w0 and r.end_ns <= w1]
    seconds = sum(r.end_ns - r.start_ns for r in hits) * 1e-9
    if seconds <= 0.0:
        return None
    return sum(r.n for r in hits) / seconds
