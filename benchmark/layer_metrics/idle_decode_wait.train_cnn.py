"""Device idle time of a CNN training window while the main thread waits
on host decode: inside ``train.prefetch_wait`` (the step loop waiting on
the prefetch thread) or ``extract.wait`` (mining's extraction waiting on
its decode thread), each the innermost open span, over the window, in %
(``benchmark.harness.program_spans``)."""

from benchmark.harness.program_spans import idle_pct


def read(run):
    return idle_pct(run, ("train.prefetch_wait", "extract.wait"))
