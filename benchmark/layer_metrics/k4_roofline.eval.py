"""K4 (``ops/flash_attention.py``) in extraction: its forward launches at
the extraction batch and the token counts the model reference module
gives, least time over device time, in %."""

from benchmark.roofline.reading import k4_eval as read  # noqa: F401
