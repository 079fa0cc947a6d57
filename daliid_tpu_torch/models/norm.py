"""Eval-mode batch normalization with the JAX package's numerics.

Port of ``daliid_tpu/models/norm.py::TorchBatchNorm`` (``:34-84``) in eval
mode: the running statistics and the affine ``(x - mean) * scale *
rsqrt(var + eps) + bias`` are applied in float32 (a bf16 input is upcast
inside torch's eval ``batch_norm``), and the result is cast back to the
compute dtype. Parameters and buffers carry
torch's names (``weight``, ``bias``, ``running_mean``, ``running_var``), so
a reference ``state_dict`` loads as it is.

Training is not ported here. The train-mode rule belongs to the training
slice: normalize with the biased batch variance, update the running
variance with the unbiased one (``n / (n - 1)``), torch momentum 0.1 (flax
0.9), see ``daliid_tpu/models/norm.py:3-10,63-79``.
"""

from __future__ import annotations

import torch
from torch import nn


class TorchBatchNorm(nn.Module):
    """BatchNorm over the channel axis (dim 1) of an (N, C, ...) tensor,
    eval mode only."""

    def __init__(self, num_features: int, eps: float = 1e-5, dtype: torch.dtype | None = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # one fused pass: the eval batch_norm kernel reads a bf16 input, does
        # its arithmetic in f32 against the f32 statistics, writes x's dtype
        y = torch.nn.functional.batch_norm(
            x, self.running_mean.float(), self.running_var.float(),
            self.weight.float(), self.bias.float(), training=False, eps=self.eps,
        )
        return y.to(self.dtype or x.dtype)
