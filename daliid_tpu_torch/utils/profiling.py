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
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict

import torch


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
    elapsed seconds once it has ended. The span is a
    ``record_function`` range; ``block_on`` (tensors, or containers of
    them) is waited for before the clock is read."""
    elapsed = [0.0]
    t0 = time.time()
    with torch.profiler.record_function(name):
        yield lambda: elapsed[0]
        if block_on is not None:
            _synchronize(block_on)
    elapsed[0] = time.time() - t0


@contextlib.contextmanager
def trace_annotation(name: str):
    """A bare named range in the ``torch.profiler`` trace."""
    with torch.profiler.record_function(name):
        yield


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
