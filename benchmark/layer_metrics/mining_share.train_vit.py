"""Share of a transformer training window spent in proxy mining, in %
(``benchmark.roofline.reading.mining_share``)."""

from benchmark.roofline.reading import mining_share as read  # noqa: F401
