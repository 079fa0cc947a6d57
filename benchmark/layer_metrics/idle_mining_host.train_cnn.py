"""Device idle time of a CNN training window inside ``mine.host``, the
host's farthest-point mining in ``Trainer.mine_proxies`` (the innermost
span open on the main thread), over the window, in %
(``benchmark.harness.program_spans``)."""

from benchmark.harness.program_spans import idle_pct


def read(run):
    return idle_pct(run, ("mine.host",))
