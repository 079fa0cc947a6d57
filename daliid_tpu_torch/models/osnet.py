"""OSNet-x1.0 ReID backbone: omni-scale residual blocks, 512-d head.

Port of ``daliid_tpu/models/osnet.py``: :class:`ConvBNReLU` (``:26-40``),
:class:`LiteConv3x3` (``:43-59``), :class:`ChannelGate` (``:62-76``),
:class:`OSBlock` (``:79-110``) and :class:`OSNetReID` (``:113-141``). A
stem 7x7/2 and a max pool; three omni-scale stages of 2 blocks (256, 384
and 512 channels), the first two followed by a 1x1 transition and a 2x2
average pool; a last 1x1 convolution; GAP + GMP (``feature`` = gap, gmp or
both) into an f32 BN neck.

Each :class:`OSBlock` runs 4 streams of 1 to 4 stacked lite convolutions
(1x1 pointwise, then 3x3 depthwise), and ONE :class:`ChannelGate` gates
every stream (one submodule called four times, as in flax, where one module
instance is called four times). The gate's squeeze width is
``max(channels // 16, 4)``.

``state_dict`` keys are the reference checkpoint's (torchreid ``osnet_x1_0``
under the ``OSNETReID`` wrapper, the scheme of
``daliid_tpu/models/torch_port.py:508-572``): ``conv1.conv``,
``conv2.0.conv1.conv``, ``conv2.0.conv2a.conv1`` (pointwise) /
``conv2`` (depthwise), ``conv2.0.conv2b.1.bn``, ``conv2.0.gate.fc1``
(a 1x1 convolution with bias), ``conv2.0.conv3.conv``,
``conv2.0.downsample.conv``, ``conv2.2.0.conv`` (the transition),
``conv5.conv``, ``last_bn``. BN epsilon is 1e-5 throughout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from daliid_tpu_torch.models.norm import TorchBatchNorm
from daliid_tpu_torch.models.resnet import Conv, Dense1x1, pool_features


class ConvBNReLU(nn.Module):
    """kxk convolution (padding k // 2) → BN → ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, stride=stride, padding=kernel // 2)
        self.bn = TorchBatchNorm(cout, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class Conv1x1Linear(nn.Module):
    """1x1 convolution → BN, no activation (the expand and shortcut)."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(cin, cout, 1)
        self.bn = TorchBatchNorm(cout, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class LiteConv3x3(nn.Module):
    """1x1 pointwise (``conv1``) → 3x3 depthwise (``conv2``) → BN → ReLU."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(cin, cout, 1)
        self.conv2 = Conv(cout, cout, 3, padding=1, groups=cout)
        self.bn = TorchBatchNorm(cout, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv2(self.conv1(x))))


class ChannelGate(nn.Module):
    """GAP → fc reduce → ReLU → fc expand → sigmoid, times the input."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 4)
        self.fc1 = Dense1x1(channels, hidden)
        self.fc2 = Dense1x1(hidden, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = x.mean(dim=(2, 3), keepdim=True)
        g = torch.sigmoid(self.fc2(F.relu(self.fc1(g))))
        return x * g


class OSBlock(nn.Module):
    """Four streams of depth 1..4 lite convolutions under one shared gate,
    a 1x1 expand, a projection shortcut on a change of width, residual add."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        mid = cout // 4
        self.conv1 = ConvBNReLU(cin, mid, 1, dtype=dtype)
        self.conv2a = LiteConv3x3(mid, mid, dtype=dtype)
        for depth, stream in ((2, "b"), (3, "c"), (4, "d")):
            self.add_module(f"conv2{stream}", nn.Sequential(
                *[LiteConv3x3(mid, mid, dtype=dtype) for _ in range(depth)]))
        self.gate = ChannelGate(mid)
        self.conv3 = Conv1x1Linear(mid, cout, dtype=dtype)
        self.downsample = Conv1x1Linear(cin, cout, dtype=dtype) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x)
        merged = (self.gate(self.conv2a(y)) + self.gate(self.conv2b(y))
                  + self.gate(self.conv2c(y)) + self.gate(self.conv2d(y)))
        out = self.conv3(merged)
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class OSNetReID(nn.Module):
    """OSNet-x1.0 trunk + the reference's ReID head → (B, 512) f32."""

    def __init__(self, feature: str = "both", dtype: torch.dtype = torch.float32,
                 feature_dim: int = 512):
        super().__init__()
        if feature not in ("gap", "gmp", "both"):
            raise ValueError(f"feature must be gap|gmp|both, got {feature!r}")
        self.feature = feature
        self.dtype = dtype
        self.feature_dim = feature_dim
        self.conv1 = ConvBNReLU(3, 64, 7, 2, dtype=dtype)
        cin = 64
        for stage, ch in enumerate((256, 384, 512), start=2):
            layers = [OSBlock(cin, ch, dtype=dtype), OSBlock(ch, ch, dtype=dtype)]
            if stage < 4:  # transition: 1x1 conv + 2x2 average pool
                layers.append(nn.Sequential(ConvBNReLU(ch, ch, 1, dtype=dtype),
                                            nn.AvgPool2d(2, stride=2)))
            self.add_module(f"conv{stage}", nn.Sequential(*layers))
            cin = ch
        self.conv5 = ConvBNReLU(512, 512, 1, dtype=dtype)
        self.last_bn = TorchBatchNorm(512, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x.to(self.dtype))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.conv5(self.conv4(self.conv3(self.conv2(x))))
        return self.last_bn(pool_features(x, self.feature))
