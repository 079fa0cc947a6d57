"""Share of the traced evaluation window in which no operation ran on the
device (the union of the trace's device spans), in %."""

from benchmark.roofline.reading import idle_pct


def read(run):
    return idle_pct(run)
