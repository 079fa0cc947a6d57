"""Share of the traced training window of a transformer in which no
operation ran on the device (the union of the trace device spans), in %."""

from benchmark.roofline.reading import idle_pct as read  # noqa: F401
