"""K1 (``ops/fused_augment.py``) in a transformer training window: the
least time of its launches at the step batch over their device time, in %."""

from benchmark.roofline.reading import k1_train as read  # noqa: F401
