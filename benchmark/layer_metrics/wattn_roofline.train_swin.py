"""The biased windowed-attention kernel (``wattn_bias_mma``) in a Swin
training window: its forward launches in the steps and in mining, at the
windows, tokens, heads and bias the model's reference module gives (its
``window_attention(cfg)``), least time over device time, in %."""

from benchmark.roofline.window_attention import train_share as read  # noqa: F401
