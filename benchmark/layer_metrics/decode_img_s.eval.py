"""The extractor's own decode rate in the evaluation window: the images
counted in the ``extract.decode`` spans of its producer thread that lie in
the window, over their summed seconds, in img/s
(``benchmark.harness.program_spans``)."""

from benchmark.harness.program_spans import rate


def read(run):
    return rate(run, "extract.decode")
