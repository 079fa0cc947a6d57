"""Tracing and profiling: phase timers and ``torch.profiler`` integration.

Port of ``daliid_tpu/utils/profiling.py``:

- :class:`PhaseTimer` (``:30-60``) accumulates named host-clock spans, the
  reference's feature-extraction / clustering / finetuning accounting
  (``mainKIT.py:102-104,193-201``); each of the trainer's spans ends in a
  host sync of its own (features or metrics copied to the host);
- :func:`phase` (``:63-74``) times one span, under a
  ``torch.profiler.record_function`` range so that it shows in a
  ``torch.profiler`` trace; before it reads the clock it synchronizes the
  CUDA devices of the tensors in ``block_on`` (the counterpart of
  ``jax.block_until_ready``: kernels run asynchronously, so a span that
  does not wait for them times their launch);
- :func:`trace_annotation` (``:77-81``) is a bare named range;
- :func:`profile_to` (``:84-88``) captures a ``torch.profiler`` trace of
  the host and, where a card is present, the device, and exports it as a
  Chrome / Perfetto JSON under ``log_dir``.

Beyond the JAX package, :func:`span` is the port's program span: while a
``torch.profiler`` records (``torch.autograd.profiler._is_profiler_enabled``),
it opens a ``record_function`` range and keeps a :class:`SpanRecord` in a
bounded buffer in memory (:func:`span_records` reads it): the name, the
thread, start and end on ``time.time_ns()`` (the clock the profiler stamps
its host events with), the span that caused it and a count of the work done
inside it. While no profiler records, a span is one flag test: no range, no
clock read, no allocation. ``phase`` and ``trace_annotation`` are spans, so
``PhaseTimer``'s spans are records too.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# records kept at most (the oldest are dropped first): a training epoch of
# the benchmark's cells keeps a few hundred
SPAN_RECORDS_MAX = 1 << 16


class SpanRecord(NamedTuple):
    """One ended span: ``parent`` is the ``id`` of the span that caused it
    (None for a root), ``n`` the work counted inside it (images, rows,
    classes) or None."""

    id: int
    name: str
    thread: int  # threading.get_ident() of the thread it ran on
    start_ns: int
    end_ns: int
    parent: Optional[int]
    n: Optional[int]


_records: collections.deque = collections.deque(maxlen=SPAN_RECORDS_MAX)
_ids = itertools.count()
# per thread: ``stack``, the ids of its open spans, innermost last; ``base``,
# the parent of its outermost spans (a worker thread's, see adopt_span)
_local = threading.local()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "n", "parent", "id", "start", "_range")

    def __init__(self, name: str, n, parent):
        self.name, self.n, self.parent = name, n, parent

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        if self.parent is None:
            self.parent = stack[-1] if stack else getattr(_local, "base", None)
        self.id = next(_ids)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.remove(self.id)
        self._range.__exit__(*exc)
        _records.append(SpanRecord(self.id, self.name, threading.get_ident(), self.start, end,
                                   self.parent, self.n))
        return False


def span(name: str, n: Optional[int] = None, parent: Optional[int] = None):
    """A program span around the body, recorded only while a
    ``torch.profiler`` records (else a shared null context). Its parent is
    ``parent`` if given, else the innermost span open on this thread, else
    the span this thread adopted (:func:`adopt_span`). ``n`` counts the work
    done inside it. The span reads nothing of the device and synchronizes
    nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, n, parent)


def current_span() -> Optional[int]:
    """The id of the innermost span open on this thread (or the one it
    adopted), None if there is none: the parent to hand to a thread this
    thread starts."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else getattr(_local, "base", None)


def adopt_span(parent: Optional[int]) -> None:
    """Make ``parent`` the parent of this thread's outermost spans (a
    thread's initializer: the span that started the thread)."""
    _local.base = parent


def span_records() -> list:
    """The kept :class:`SpanRecord` s, in the order they ended."""
    return list(_records)


class PhaseTimer:
    """Accumulates (count, total seconds) per named phase."""

    def __init__(self):
        self._totals: Dict[str, float] = collections.defaultdict(float)
        self._counts: Dict[str, int] = collections.defaultdict(int)

    def add(self, name: str, seconds: float) -> None:
        self._totals[name] += seconds
        self._counts[name] += 1

    def mean(self, name: str) -> float:
        return self._totals[name] / max(self._counts[name], 1)

    def report(self) -> str:
        lines = []
        for name in sorted(self._totals):
            lines.append(
                f"{name}: total {self._totals[name]:.2f}s, "
                f"mean {self.mean(name):.3f}s over {self._counts[name]} spans"
            )
        return "\n".join(lines)

    def total(self, name: str) -> float:
        return self._totals[name]

    @contextlib.contextmanager
    def span(self, name: str, block_on=None):
        """Time one span under ``name`` (see :func:`phase`)."""
        with phase(name, block_on=block_on) as get_elapsed:
            yield
        self.add(name, get_elapsed())


def _synchronize(tree) -> None:
    """Wait for the CUDA devices of every tensor in ``tree`` (a tensor, or
    lists, tuples and dicts of them)."""
    stack, devices = [tree], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def phase(name: str, block_on=None):
    """Time one span; yields a zero-argument callable that returns its
    elapsed seconds once it has ended. The span is a :func:`span`;
    ``block_on`` (tensors, or containers of them) is waited for before the
    clock is read."""
    elapsed = [0.0]
    t0 = time.time()
    with span(name):
        yield lambda: elapsed[0]
        if block_on is not None:
            _synchronize(block_on)
    elapsed[0] = time.time() - t0


def trace_annotation(name: str):
    """A bare named range in the ``torch.profiler`` trace (a :func:`span`)."""
    return span(name)


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Capture a ``torch.profiler`` trace of the body (the host, and the
    device when a card is present) and write it to
    ``<log_dir>/trace.json`` (Chrome / Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
