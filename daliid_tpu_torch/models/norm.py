"""Batch and instance normalization with the JAX package's numerics.

:class:`InstanceNorm` is flax's ``nn.InstanceNorm`` as the IBN block of
``daliid_tpu/models/resnet.py`` uses it (see its docstring).
:class:`TorchBatchNorm` ports ``daliid_tpu/models/norm.py::TorchBatchNorm``
(``:34-84``). Its mode follows ``self.training``:

- train: normalize with the biased batch variance and update the running
  variance with the unbiased one (``n / (n - 1)``), torch momentum 0.1
  (flax 0.9), as ``daliid_tpu/models/norm.py:63-79`` does;
- eval: the running statistics.

In both, the statistics and the affine are f32 (a bf16 input is upcast
inside torch's ``batch_norm``, whose running buffers stay f32 through an
update), and the result is cast to the compute dtype. Every row of the input
counts in the batch statistics, masked padding slots of a PK batch
included, as in the JAX package. The JAX package computes the batch
variance as ``E[x^2] - mean^2`` clipped at 0; torch uses Welford, so the two
agree to a tolerance. Parameters and buffers carry torch's names
(``weight``, ``bias``, ``running_mean``, ``running_var``) and there is no
``num_batches_tracked`` buffer, so a reference ``state_dict`` loads as it is
once that counter is dropped.
"""

from __future__ import annotations

import torch
from torch import nn

# torch convention: new = (1 - momentum) * old + momentum * batch (flax 0.9)
MOMENTUM = 0.1


class TorchBatchNorm(nn.Module):
    """BatchNorm over the channel axis (dim 1) of an (N, C, ...) tensor."""

    def __init__(self, num_features: int, eps: float = 1e-5, dtype: torch.dtype | None = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # one fused pass: batch_norm reads a bf16 input, does its arithmetic in
        # f32 against the f32 parameters and statistics, writes x's dtype; in
        # train mode it updates the f32 running buffers in place
        y = torch.nn.functional.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            training=self.training, momentum=MOMENTUM, eps=self.eps,
        )
        return y.to(self.dtype or x.dtype)


class InstanceNorm(nn.Module):
    """flax ``nn.InstanceNorm(epsilon=1e-5)`` over an (N, C, H, W) tensor:
    each sample's and channel's mean and variance over H and W, computed in
    f32 whatever the input dtype, the variance flax's fast ``E[x^2] -
    E[x]^2`` clipped at 0; then ``(x - mean) * (rsqrt(var + eps) * weight)
    + bias`` in f32, cast to the compute dtype. ``weight`` and ``bias`` are
    the reference IBN block's ``IN.weight`` and ``IN.bias``; there are no
    running statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5, dtype: torch.dtype | None = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = ((xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight[:, None, None]
        y = (xf - mean) * mul + self.bias[:, None, None]
        return y.to(self.dtype or x.dtype)
