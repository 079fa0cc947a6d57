"""K4's backward (``k4_grad_dq`` and ``k4_grad_dkv``, two kernels a call) in a
transformer training window: one call a forward launch of the steps, at the
token counts the model's reference module gives, least time over device
time, in %."""

from benchmark.roofline.attention_grad import k4_grad_train as read  # noqa: F401
