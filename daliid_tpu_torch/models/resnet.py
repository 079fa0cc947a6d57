"""ResNet-50 ReID backbone: last-stride-1, GAP+GMP, BN neck.

Port of ``daliid_tpu/models/resnet.py``: :class:`Bottleneck` (``:49-87``),
the trunk of ``_resnet_trunk`` (``:90-117``) and :class:`ResNet50ReID`
(``:120-163``) as ``nn.Module``s. The quirks of the reference wrapper
survive:

- no ReLU after the stem BN (``resnet.py:102``);
- ``last_stride`` 1 on stage 4 (``:106``);
- GAP + GMP summed, with ``feature`` = gap, gmp or both (``:147-154``);
- an f32 BN neck ``last_bn`` (``:156-160``);
- ``stage_sizes`` is a parameter.

The module runs in eval mode (running BN statistics) or, after
``module.train()``, in train mode (batch statistics, running statistics
updated), the JAX package's ``train=True``.

Layout: inputs are NCHW-logical in ``channels_last`` memory. Parameters are
f32; convolutions run in the compute ``dtype`` (bf16 on the GPU by default)
through ``torch.nn.functional.conv2d`` (cuDNN). Padding matches flax's: the
explicit 3 and 1 of the 7x7 and 3x3 convolutions, and flax's ``'SAME'`` on
the 1x1 convolutions, which for a 1x1 kernel is no padding at any stride
and any input size. ``state_dict`` keys are the reference's torch keys
(``conv1``, ``layer3.2.bn1.running_mean``, ``layer4.0.downsample.0``,
``last_bn``, ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from daliid_tpu_torch.models.norm import TorchBatchNorm


class Conv(nn.Conv2d):
    """Bias-free convolution that runs in its input's dtype (f32 weights
    cast at call time) and keeps ``channels_last``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, padding: int = 0):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(dtype=x.dtype, memory_format=torch.channels_last)
        return F.conv2d(x, w, None, self.stride, self.padding)


class Bottleneck(nn.Module):
    """torchvision-v1.5 bottleneck: 1x1 → 3x3(stride) → 1x1, projection
    shortcut on a change of shape."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = Conv(cin, planes, 1)
        self.bn1 = TorchBatchNorm(planes, dtype=dtype)
        self.conv2 = Conv(planes, planes, 3, stride=stride, padding=1)
        self.bn2 = TorchBatchNorm(planes, dtype=dtype)
        self.conv3 = Conv(planes, out_ch, 1)
        self.bn3 = TorchBatchNorm(out_ch, dtype=dtype)
        self.downsample = None
        if cin != out_ch or stride != 1:
            # flax 'SAME' on a 1x1 kernel pads nothing, whatever the stride
            self.downsample = nn.Sequential(
                Conv(cin, out_ch, 1, stride=stride), TorchBatchNorm(out_ch, dtype=dtype)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet50ReID(nn.Module):
    """ResNet trunk + ReID head: ``forward(x)`` → (B, 2048) f32 embedding."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), feature: str = "both",
                 last_stride: int = 1, dtype: torch.dtype = torch.float32,
                 feature_dim: int = 2048):
        super().__init__()
        if feature not in ("gap", "gmp", "both"):
            raise ValueError(f"feature must be gap|gmp|both, got {feature!r}")
        self.feature = feature
        self.dtype = dtype
        self.feature_dim = feature_dim
        self.conv1 = Conv(3, 64, 7, stride=2, padding=3)
        self.bn1 = TorchBatchNorm(64, dtype=dtype)
        cin = 64
        strides = (1, 2, 2, last_stride)
        for stage, (n_blocks, planes, s) in enumerate(
            zip(stage_sizes, (64, 128, 256, 512), strides), start=1
        ):
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(cin, planes, stride=s if b == 0 else 1, dtype=dtype))
                cin = planes * Bottleneck.expansion
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.last_bn = TorchBatchNorm(cin, dtype=torch.float32)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = self.bn1(self.conv1(x))
        # no stem ReLU — matches the reference forward
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(1, self.num_stages + 1):
            x = getattr(self, f"layer{stage}")(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.trunk(x)
        gap = x.mean(dim=(2, 3))
        gmp = x.amax(dim=(2, 3))
        if self.feature == "gap":
            pooled = gap
        elif self.feature == "gmp":
            pooled = gmp
        else:
            pooled = gap + gmp
        return self.last_bn(pooled.float())
