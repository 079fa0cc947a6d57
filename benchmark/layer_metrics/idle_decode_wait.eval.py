"""Device idle time of the evaluation window while the main thread waits
on the extractor's decode thread (``extract.wait``, the innermost open
span), over the window, in % (``benchmark.harness.program_spans``)."""

from benchmark.harness.program_spans import idle_pct


def read(run):
    return idle_pct(run, ("extract.wait",))
