"""K2 (``ops/rank_counts.py``) at the protocol's Q, G, the positive bound P
the ranking takes and the counted positives: least time over device time,
in %."""

from benchmark.roofline import k2_rank_counts
from benchmark.roofline.reading import K2, kernel_pct


def read(run):
    q, g, p, valid = run.shapes["k2"]
    return kernel_pct(run, K2, [k2_rank_counts(q, g, p, valid)] * run.counts["evaluations"])
