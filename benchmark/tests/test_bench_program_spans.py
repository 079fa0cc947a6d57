"""The program-span helper (``benchmark/harness/program_spans.py``) and its
eight readers on a synthetic trace and synthetic records: idle time is the
complement of the union of the device events, clipped to the window, put
down to the innermost span of the main thread; other threads' spans give
rates only; every reader gives None without a trace, without records, or
where the two do not meet. On the card: the records and the device trace
share one clock."""

from __future__ import annotations

import sys
import threading
import types

import pytest

from benchmark.harness import core, program_spans, tracing
from benchmark.tests.tiny import tiny_workload
from daliid_tpu_torch.utils.profiling import SpanRecord

MAIN = threading.main_thread().ident
OTHER = MAIN + 1
T0 = 1_700_000_000.0          # the window's start, seconds on time.time()
# timestamps near 1.7e18 ns hold a float64 to a quarter of a microsecond
SECONDS_TOL = 1e-6
READERS = ("idle_mining_host.train_cnn", "idle_mining_host.train_vit",
           "idle_decode_wait.train_cnn", "idle_decode_wait.train_vit",
           "idle_launch.train_cnn", "idle_launch.train_vit",
           "idle_decode_wait.eval", "decode_img_s.eval")


def approx(value, tol: float = SECONDS_TOL):
    return pytest.approx(value, abs=tol)


def _ns(ms: float) -> int:
    """ms after the window's start → ns on time.time_ns()."""
    return int(round(T0 * 1e9)) + int(round(ms * 1e6))


def _kernel(start_ms: float, end_ms: float, name: str = "k") -> tuple:
    """A device event as ``tracing.Trace.kernels`` holds it (µs)."""
    return (name, _ns(start_ms) / 1e3, (end_ms - start_ms) * 1e3)


def _rec(i: int, name: str, start_ms: float, end_ms: float, thread: int = MAIN,
         parent: int | None = None, n: int | None = None) -> SpanRecord:
    return SpanRecord(i, name, thread, _ns(start_ms), _ns(end_ms), parent, n)


def _run(kernels, window_ms: float = 100.0, cell: str = "resnet50.train-market"):
    run = core.Run(cell=cell, workload=tiny_workload(cell), config={}, seed=1, seconds=0.1,
                   trace=True, device="cpu", t_start=T0 - 5.0)
    run.setup_s, run.window_s = 5.0, window_ms * 1e-3
    if kernels is not None:
        run.tracer = tracing.Trace(kernels=list(kernels), window_s=run.window_s)
    return run


@pytest.fixture
def records(monkeypatch):
    held: list = []
    monkeypatch.setattr(program_spans, "program_records", lambda: list(held))
    return held


def test_idle_is_the_complement_of_the_union_of_device_events_in_the_window(records):
    # overlapping events count once; one starts before the window, one ends after it
    kernels = [_kernel(-5, 10), _kernel(5, 20), _kernel(15, 30), _kernel(50, 60),
               _kernel(55, 58), _kernel(90, 130)]
    records.append(_rec(0, "train.step", 0, 100))
    att = program_spans.attribution(_run(kernels))
    # idle: 30-50 and 60-90
    assert att.idle_s == approx(0.050)
    assert att.by_span == approx({"train.step": 0.050})
    assert att.window_s == approx(0.1) and att.first_event_s == approx(0.0)


def test_idle_goes_to_the_innermost_main_thread_span(records):
    kernels = [_kernel(0, 10), _kernel(70, 100)]
    records += [
        _rec(0, "proxy_mining", 5, 80),
        _rec(1, "mine.extract", 8, 30, parent=0),
        _rec(2, "extract.wait", 12, 20, parent=1),
        _rec(3, "mine.host", 40, 60, parent=0),
        # another thread's span over the idle time is not the main thread's
        _rec(4, "extract.decode", 0, 70, thread=OTHER, parent=1, n=64),
    ]
    att = program_spans.attribution(_run(kernels))
    # idle 10-70: 10-12 and 20-30 mine.extract, 12-20 extract.wait,
    # 30-40 and 60-70 proxy_mining, 40-60 mine.host
    assert att.idle_s == approx(0.060)
    assert att.by_span == approx({"mine.extract": 0.012, "extract.wait": 0.008,
                                  "proxy_mining": 0.020, "mine.host": 0.020})
    assert att.seen == {"proxy_mining", "mine.extract", "extract.wait", "mine.host"}


def test_idle_outside_every_main_thread_span_has_no_span(records):
    kernels = [_kernel(0, 10), _kernel(90, 100)]
    records += [_rec(0, "train.step", 20, 30),
                _rec(1, "train.decode", 0, 100, thread=OTHER, n=384)]
    att = program_spans.attribution(_run(kernels))
    assert att.by_span == approx({"train.step": 0.010, program_spans.NO_SPAN: 0.070})


def test_the_innermost_pieces_of_nested_and_touching_spans():
    pieces = program_spans.innermost([(0, 10, "a"), (2, 4, "b"), (4, 6, "c"), (6, 6, "d"),
                                      (12, 14, "e")])
    assert pieces == [(0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 10, "a"), (12, 14, "e")]


def test_the_eight_readers_on_a_training_window(records):
    kernels = [_kernel(0, 10), _kernel(30, 40), _kernel(60, 100)]
    records += [
        _rec(0, "proxy_mining", 0, 30),
        _rec(1, "mine.extract", 0, 15, parent=0, n=1000),
        _rec(2, "extract.wait", 10, 14, parent=1),
        _rec(3, "mine.host", 15, 30, parent=0, n=10),
        _rec(4, "finetuning", 30, 100),
        _rec(5, "train.prefetch_wait", 40, 45, parent=4),
        _rec(6, "train.step", 45, 60, parent=4, n=384),
        _rec(7, "train.decode", 30, 50, thread=OTHER, parent=4, n=384),
    ]
    got = {name: core.metric_reader(name).read(_run(kernels)) for name in READERS}
    # idle 10-30 and 40-60 of 100 ms
    assert got["idle_mining_host.train_cnn"] == approx(15.0, 1e-3)
    assert got["idle_decode_wait.train_cnn"] == approx(4.0 + 5.0, 1e-3)
    assert got["idle_launch.train_cnn"] == approx(15.0, 1e-3)
    for name in ("idle_mining_host", "idle_decode_wait", "idle_launch"):
        assert got[f"{name}.train_vit"] == got[f"{name}.train_cnn"]
    assert got["idle_decode_wait.eval"] == approx(4.0, 1e-3)
    assert got["decode_img_s.eval"] is None  # no extract.decode span


def test_the_decode_rate_counts_the_spans_inside_the_window(records):
    kernels = [_kernel(0, 100)]
    records += [
        _rec(0, "extract.wait", 0, 1),
        _rec(1, "extract.decode", 0, 40, thread=OTHER, n=512),
        _rec(2, "extract.decode", 40, 60, thread=OTHER, n=256),
        _rec(3, "extract.decode", 90, 120, thread=OTHER, n=512),  # ends after the window
    ]
    run = _run(kernels, cell="transreid_jpm.eval-market")
    rate = core.metric_reader("decode_img_s.eval").read(run)
    assert rate == pytest.approx(768 / 0.060, rel=1e-4)
    assert core.metric_reader("idle_decode_wait.eval").read(run) == 0.0


@pytest.mark.parametrize("case", ["no trace", "no records", "records outside the window",
                                  "no device event in the window", "only other threads"])
def test_every_reader_gives_none_where_trace_and_records_do_not_meet(records, case):
    kernels = [] if case == "no trace" else [_kernel(0, 10)]
    if case == "no device event in the window":
        kernels = [_kernel(-30, -10)]
    if case == "records outside the window":
        records.append(_rec(0, "mine.host", 200, 300))
    elif case == "only other threads":
        records.append(_rec(0, "extract.decode", 0, 50, thread=OTHER, n=512))
    elif case != "no records":
        records.append(_rec(0, "mine.host", 10, 50))
    run = _run(None if case == "no trace" else kernels)
    for name in READERS:
        assert core.metric_reader(name).read(run) is None, name


def test_a_program_without_spans_gives_no_records(monkeypatch):
    monkeypatch.setitem(sys.modules, "daliid_tpu_torch.utils.profiling",
                        types.ModuleType("daliid_tpu_torch.utils.profiling"))
    assert program_spans.program_records() == []


def test_the_port_s_records_reach_the_readers():
    """The port's own spans, recorded while a profiler records, are what
    the helper reads, on the main thread's clock."""
    import time

    import torch

    from daliid_tpu_torch.utils.profiling import span

    t0 = time.time()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("mine.host", n=3):
            time.sleep(0.02)
    run = _run(None)
    run.t_start, run.setup_s, run.window_s = t0 - 1.0, 1.0, time.time() - t0
    run.tracer = tracing.Trace(kernels=[("k", t0 * 1e6, 1.0)], window_s=run.window_s)
    share = core.metric_reader("idle_mining_host.train_cnn").read(run)
    assert share is not None and 0.0 < share < 100.0


@pytest.mark.card
def test_spans_and_the_device_trace_share_one_clock(card):
    """A span around a device sleep and its synchronize holds the sleep
    kernel's interval as the benchmark's trace summary gives it."""
    import torch

    from daliid_tpu_torch.utils.profiling import span, span_records

    cycles = 20_000_000  # about 10 ms
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            with span("clock.sleep"):
                torch.cuda._sleep(cycles)
                torch.cuda.synchronize()
    recs = [r for r in span_records() if r.name == "clock.sleep"][-5:]
    tr = tracing.summarize(prof, 1.0)
    sleeps = [(s, d) for n, s, d in tr.kernels if "spin" in n]
    assert len(sleeps) == len(recs) == 5
    margins = []
    for r, (s, d) in zip(recs, sleeps):
        lead, tail = s * 1e3 - r.start_ns, r.end_ns - (s + d) * 1e3
        margins.append((lead / 1e3, tail / 1e3))
    print(f"[clock] {torch.cuda.get_device_name(0)}: sleep kernel inside its span, "
          f"µs from the span's start to the kernel's, and from the kernel's end to the "
          f"span's: {margins}")
    assert all(lead > 0 and tail > 0 for lead, tail in margins)
