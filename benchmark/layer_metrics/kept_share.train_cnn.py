"""Share of a CNN training window's mined images that mining's extraction
served from the batches it kept on the device: the images counted in the
``extract.kept`` spans that lie wholly in the window over the window's
mined images (``run.counts["mined_images"]``), in %
(``benchmark.harness.program_spans``). None without a trace or records,
and for a program whose extractor cannot keep batches (no ``keep``
argument to ``FeatureExtractor.extract``)."""

import inspect

from benchmark.harness.program_spans import _window_ns, attribution


def read(run):
    try:
        from daliid_tpu_torch.eval.features import FeatureExtractor
    except ImportError:
        return None
    if "keep" not in inspect.signature(FeatureExtractor.extract).parameters:
        return None
    att = attribution(run)
    mined = run.counts.get("mined_images")
    if att is None or not mined:
        return None
    w0, w1 = _window_ns(run)
    kept = sum(r.n or 0 for r in att.records
               if r.name == "extract.kept" and r.start_ns >= w0 and r.end_ns <= w1)
    return 100.0 * kept / mined
