"""Model FLOPs of the evaluation window (one forward for each real image
extracted) over (window x bf16 peak), in %."""

from benchmark.roofline.reading import eval_mfu as read  # noqa: F401
