"""Inception-V3 ReID backbone.

Port of ``daliid_tpu/models/inception.py``: :class:`BasicConv`
(``:19-37``), the mixed blocks :class:`MixedA` (5b-5d, ``:40-58``),
:class:`ReductionA` (6a, ``:61-73``), :class:`MixedB` (6b-6e, ``:76-97``),
:class:`ReductionB` (7a, ``:100-116``), :class:`MixedC` (7b/7c,
``:119-136``) and :class:`InceptionV3ReID` (``:139-179``): the published
stem and mixed blocks, GAP + GMP (``feature``) into a 2048-d f32 BN neck;
no auxiliary classifier.

Padding is flax's explicit padding: symmetric integers, and ``(0, 3)`` /
``(3, 0)`` for the factorized ``(1, 7)`` / ``(7, 1)`` kernels (``(0, 1)`` /
``(1, 0)`` for ``(1, 3)`` / ``(3, 1)``). flax's unpadded ``max_pool`` is
``max_pool2d(3, 2)`` with floor; its ``avg_pool`` padded by 1 divides by
the whole window, which is ``avg_pool2d``'s ``count_include_pad=True``.
The stem downsamples by 8 before the mixed blocks: inputs below about 75
pixels collapse, so use 256x128 (or 128x128 for small tests).

BN epsilon is 1e-3 in every :class:`BasicConv` and 1e-5 in ``last_bn``.
``state_dict`` keys are the reference checkpoint's (torchvision
``inception_v3`` attributes under the ``inceptionV3ReID`` wrapper, the
scheme of ``daliid_tpu/models/torch_port.py:680-757``): ``Conv2d_1a_3x3.conv``,
``Mixed_5b.branch5x5_1.bn``, ``Mixed_6b.branch7x7dbl_4.conv``,
``Mixed_7c.branch3x3_2a.conv``, ``last_bn``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from daliid_tpu_torch.models.norm import TorchBatchNorm
from daliid_tpu_torch.models.resnet import Conv, pool_features


class BasicConv(nn.Module):
    """Convolution → BN (eps 1e-3) → ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0,
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, stride=stride, padding=padding)
        self.bn = TorchBatchNorm(cout, eps=1e-3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _cat(parts) -> torch.Tensor:
    return torch.cat(parts, dim=1).contiguous(memory_format=torch.channels_last)


def _avg3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1)  # count_include_pad=True


class MixedA(nn.Module):
    """Blocks 5b/5c/5d: 1x1 / 5x5 / double 3x3 / pool branches."""

    def __init__(self, cin: int, pool_channels: int, dtype=torch.float32):
        super().__init__()
        c = lambda i, o, k, p=0: BasicConv(i, o, k, padding=p, dtype=dtype)
        self.branch1x1 = c(cin, 64, 1)
        self.branch5x5_1 = c(cin, 48, 1)
        self.branch5x5_2 = c(48, 64, 5, 2)
        self.branch3x3dbl_1 = c(cin, 64, 1)
        self.branch3x3dbl_2 = c(64, 96, 3, 1)
        self.branch3x3dbl_3 = c(96, 96, 3, 1)
        self.branch_pool = c(cin, pool_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg3(x))
        return _cat([b1, b5, b3, bp])


class ReductionA(nn.Module):
    """Block 6a: stride-2 3x3 / double 3x3 / max pool."""

    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2, dtype=dtype)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1, dtype=dtype)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1, dtype=dtype)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        d3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return _cat([b3, d3, F.max_pool2d(x, 3, stride=2)])


class MixedB(nn.Module):
    """Blocks 6b-6e: factorized 7x7 branches."""

    def __init__(self, cin: int, channels_7x7: int, dtype=torch.float32):
        super().__init__()
        c7 = channels_7x7
        c = lambda i, o, k, p=0: BasicConv(i, o, k, padding=p, dtype=dtype)
        self.branch1x1 = c(cin, 192, 1)
        self.branch7x7_1 = c(cin, c7, 1)
        self.branch7x7_2 = c(c7, c7, (1, 7), (0, 3))
        self.branch7x7_3 = c(c7, 192, (7, 1), (3, 0))
        self.branch7x7dbl_1 = c(cin, c7, 1)
        self.branch7x7dbl_2 = c(c7, c7, (7, 1), (3, 0))
        self.branch7x7dbl_3 = c(c7, c7, (1, 7), (0, 3))
        self.branch7x7dbl_4 = c(c7, c7, (7, 1), (3, 0))
        self.branch7x7dbl_5 = c(c7, 192, (1, 7), (0, 3))
        self.branch_pool = c(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        d7 = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            d7 = getattr(self, f"branch7x7dbl_{i}")(d7)
        bp = self.branch_pool(_avg3(x))
        return _cat([b1, b7, d7, bp])


class ReductionB(nn.Module):
    """Block 7a."""

    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__()
        c = lambda i, o, k, s=1, p=0: BasicConv(i, o, k, stride=s, padding=p, dtype=dtype)
        self.branch3x3_1 = c(cin, 192, 1)
        self.branch3x3_2 = c(192, 320, 3, 2)
        self.branch7x7x3_1 = c(cin, 192, 1)
        self.branch7x7x3_2 = c(192, 192, (1, 7), 1, (0, 3))
        self.branch7x7x3_3 = c(192, 192, (7, 1), 1, (3, 0))
        self.branch7x7x3_4 = c(192, 192, 3, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return _cat([b3, b7, F.max_pool2d(x, 3, stride=2)])


class MixedC(nn.Module):
    """Blocks 7b/7c: expanded filter-bank outputs."""

    def __init__(self, cin: int, dtype=torch.float32):
        super().__init__()
        c = lambda i, o, k, p=0: BasicConv(i, o, k, padding=p, dtype=dtype)
        self.branch1x1 = c(cin, 320, 1)
        self.branch3x3_1 = c(cin, 384, 1)
        self.branch3x3_2a = c(384, 384, (1, 3), (0, 1))
        self.branch3x3_2b = c(384, 384, (3, 1), (1, 0))
        self.branch3x3dbl_1 = c(cin, 448, 1)
        self.branch3x3dbl_2 = c(448, 384, 3, 1)
        self.branch3x3dbl_3a = c(384, 384, (1, 3), (0, 1))
        self.branch3x3dbl_3b = c(384, 384, (3, 1), (1, 0))
        self.branch_pool = c(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        d3 = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bp = self.branch_pool(_avg3(x))
        return _cat([b1, self.branch3x3_2a(b3), self.branch3x3_2b(b3),
                     self.branch3x3dbl_3a(d3), self.branch3x3dbl_3b(d3), bp])


class InceptionV3ReID(nn.Module):
    """Inception-V3 trunk + the reference's ReID head → (B, 2048) f32."""

    def __init__(self, feature: str = "both", dtype: torch.dtype = torch.float32,
                 feature_dim: int = 2048):
        super().__init__()
        if feature not in ("gap", "gmp", "both"):
            raise ValueError(f"feature must be gap|gmp|both, got {feature!r}")
        self.feature = feature
        self.dtype = dtype
        self.feature_dim = feature_dim
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2, dtype=dtype)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3, dtype=dtype)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1, dtype=dtype)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1, dtype=dtype)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3, dtype=dtype)
        self.Mixed_5b = MixedA(192, 32, dtype=dtype)
        self.Mixed_5c = MixedA(256, 64, dtype=dtype)
        self.Mixed_5d = MixedA(288, 64, dtype=dtype)
        self.Mixed_6a = ReductionA(288, dtype=dtype)
        self.Mixed_6b = MixedB(768, 128, dtype=dtype)
        self.Mixed_6c = MixedB(768, 160, dtype=dtype)
        self.Mixed_6d = MixedB(768, 160, dtype=dtype)
        self.Mixed_6e = MixedB(768, 192, dtype=dtype)
        self.Mixed_7a = ReductionB(768, dtype=dtype)
        self.Mixed_7b = MixedC(1280, dtype=dtype)
        self.Mixed_7c = MixedC(2048, dtype=dtype)
        self.last_bn = TorchBatchNorm(2048, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return self.last_bn(pool_features(x, self.feature))
