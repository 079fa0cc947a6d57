"""Device idle time of a CNN training window inside ``train.step``, the
host issuing a step's work while the device has run dry (the innermost span
open on the main thread), over the window, in %
(``benchmark.harness.program_spans``)."""

from benchmark.harness.program_spans import idle_pct


def read(run):
    return idle_pct(run, ("train.step",))
