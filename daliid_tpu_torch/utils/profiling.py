"""Phase timing for the trainer: named host-clock spans.

Port of ``daliid_tpu/utils/profiling.py::PhaseTimer`` (``:30-60``), the
reference's feature-extraction / clustering / finetuning accounting
(``mainKIT.py:102-104,193-201``). A span also opens a
``torch.profiler.record_function`` range, so it shows up in a
``torch.profiler`` trace. Spans time the host: each of the trainer's spans
ends in a host sync of its own (features or metrics copied to the host).
"""

from __future__ import annotations

import collections
import contextlib
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

    @contextlib.contextmanager
    def span(self, name: str):
        """Time one span under ``name`` on the host clock."""
        t0 = time.time()
        with torch.profiler.record_function(name):
            yield
        self.add(name, time.time() - t0)
