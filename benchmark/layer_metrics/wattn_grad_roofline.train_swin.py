"""The biased windowed attention's backward (``wattn_grad_mma``, one kernel a
call) in a Swin training window: one call a forward launch of the steps, at
the windows, tokens, heads and bias the model's reference module gives
(its ``window_attention(cfg)``), least time over device time, in %."""

from benchmark.roofline.attention_grad import wattn_grad_train as read  # noqa: F401
