"""The profiling helpers of the PyTorch port (``utils/profiling.py``) on the
CPU: the names the JAX package's ``daliid_tpu.utils`` exports, ``phase``'s
elapsed time and its range in a ``profile_to`` trace, ``trace_annotation``,
and ``PhaseTimer``'s accounting, whose report reads as the JAX package's."""

import json
import time

import torch

import daliid_tpu.utils as jax_utils
import daliid_tpu_torch.utils as port_utils
from daliid_tpu_torch.utils import PhaseTimer, phase, profile_to, trace_annotation


def test_the_jax_package_names_are_exported():
    assert port_utils.__all__ == jax_utils.__all__


def test_phase_and_trace_annotation_appear_in_the_profile_trace(tmp_path):
    x = torch.ones(64, 64)
    with profile_to(str(tmp_path / "trace")):
        with phase("outer_phase", block_on={"y": [x]}) as elapsed:
            with trace_annotation("inner_annotation"):
                y = x @ x
            time.sleep(0.01)
            assert elapsed() == 0.0  # read once the span has ended
    assert 0.01 <= elapsed() < 5.0 and float(y[0, 0]) == 64.0
    trace = tmp_path / "trace" / "trace.json"
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"outer_phase", "inner_annotation"} <= names


def test_phase_timer_accumulates_spans_like_the_jax_one():
    port, jax_timer = PhaseTimer(), jax_utils.PhaseTimer()
    for timer in (port, jax_timer):
        for seconds in (1.5, 0.5):
            timer.add("mining", seconds)
        timer.add("finetuning", 2.0)
    assert port.report() == jax_timer.report()
    assert port.total("mining") == 2.0 and port.mean("mining") == 1.0
    with port.span("extraction", block_on=torch.zeros(2)):
        pass
    assert "extraction: total" in port.report()
