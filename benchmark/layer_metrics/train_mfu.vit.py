"""Model FLOPs of a transformer training window over (window x bf16 peak),
in % (``benchmark.roofline.reading.train_mfu``)."""

from benchmark.roofline.reading import train_mfu as read  # noqa: F401
