"""K4 (``ops/flash_attention.py``) in a transformer training window: its
forward launches in the steps and in mining, at the token counts the model
reference module gives, least time over device time, in %."""

from benchmark.roofline.reading import k4_train as read  # noqa: F401
