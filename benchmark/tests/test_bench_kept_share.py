"""The readers ``kept_share.train_cnn`` and ``kept_share.train_vit`` on a
synthetic trace and synthetic records: the images of the window's
``extract.kept`` spans over the window's mined images, in %; None without a
trace or records, and for a program whose extractor cannot keep batches."""

from __future__ import annotations

import inspect

import pytest

from benchmark.harness import core
from benchmark.tests.test_bench_program_spans import _kernel, _rec, _run, records  # noqa: F401
from daliid_tpu_torch.eval.features import FeatureExtractor

TABLE = 1000
READERS = ("kept_share.train_cnn", "kept_share.train_vit")


def _window(records, kept_minings: int, minings: int = 3):
    """A 300 ms window of ``minings`` minings of TABLE images, the first
    ``minings - kept_minings`` decoded, the rest served from kept batches;
    a kept span of the warm-up before the window and one after it."""
    kernels = [_kernel(0, 300)]
    records += [_rec(0, "extract.kept", -50, -40, n=TABLE),
                _rec(1, "extract.kept", 310, 320, n=TABLE)]
    for i in range(minings):
        name = "extract.kept" if i >= minings - kept_minings else "extract.decode"
        records += [_rec(10 + 2 * i, "mine.extract", 100 * i, 100 * i + 30, n=TABLE),
                    _rec(11 + 2 * i, name, 100 * i + 1, 100 * i + 29, parent=10 + 2 * i,
                         n=TABLE)]
    run = _run(kernels, window_ms=300.0)
    run.counts["mined_images"] = minings * TABLE
    return run


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("kept, want", [(3, 100.0), (2, 200.0 / 3), (0, 0.0)])
def test_the_share_of_the_windows_mined_images_served_from_kept_batches(records, name, kept,
                                                                       want):
    assert core.metric_reader(name).read(_window(records, kept)) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_trace_or_records(records, name):
    reader = core.metric_reader(name)
    run = _window(records, 3)
    run.tracer = None
    assert reader.read(run) is None
    records.clear()
    assert reader.read(_window([], 3)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_for_a_program_that_cannot_keep_batches(records, name, monkeypatch):
    def extract(self, table_or_paths, turbulence_dir=None, turb_strength=None, dataset=None,
                verbose=False):
        raise AssertionError("not called")

    assert "keep" in inspect.signature(FeatureExtractor.extract).parameters
    monkeypatch.setattr(FeatureExtractor, "extract", extract)
    assert core.metric_reader(name).read(_window(records, 3)) is None
