"""The arithmetic of the reference: float32, or the float8 control.

``f32`` leaves tensors alone. ``fp8`` is the control: the product operands
of the forward and of the backward are rounded to float8 with a per-tensor
scale, and the products then run in float32. Each input and weight of a
convolution or matrix product is rounded to e4m3 (amax / 448) before the
product (``p(x)``), and the gradient that reaches the product's output is
rounded to e5m2 (amax / 57344) before the backward's products take it
(``p.grad(y)``); the saved operands of those products are the rounded
forward ones. The configurations state bfloat16, and float8 is the next
precision below it.
"""

from __future__ import annotations

import torch

MODES = ("f32", "fp8")
_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def set_strict_float32() -> None:
    """TF32 off for matrix products and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


def _fp8(x: torch.Tensor) -> torch.Tensor:
    q = _round(x.detach(), torch.float8_e4m3fn, _E4M3_MAX)
    return x + (q - x).detach()


class _RoundGrad(torch.autograd.Function):
    """The identity forward; the gradient rounded to e5m2 backward."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


class Precision:
    """Rounds the operands of products: ``p(x)`` for each input and weight,
    ``p.grad(y)`` on each product's output for the gradient it passes back."""

    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"precision must be one of {MODES}, got {mode!r}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.mode == "fp8" else x

    def grad(self, y: torch.Tensor) -> torch.Tensor:
        return _RoundGrad.apply(y) if self.mode == "fp8" and y.requires_grad else y
