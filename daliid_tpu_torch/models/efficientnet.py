"""EfficientNet-B0 ReID backbone.

Port of ``daliid_tpu/models/efficientnet.py``: :class:`SqueezeExcite`
(``:24-35``), :class:`MBConv` (``:38-69``), ``_B0_CONFIG`` (``:72-81``)
and :class:`EfficientNetB0ReID` (``:84-119``). A 3x3/2 stem; the seven
MBConv stages of the published B0 schedule (1x1 expand, kxk depthwise,
squeeze-excitation of ``max(1, in // 4)`` channels, 1x1 project, residual
when the shape holds); a 1x1 head to 1280; SiLU activations; GAP + GMP
(``feature``) into an f32 BN neck. As in the JAX package there is no
stochastic depth.

BN epsilon is 1e-3 in the trunk and 1e-5 in ``last_bn``. ``state_dict`` keys
are the reference checkpoint's (torchvision ``efficientnet_b0.features``
under the ``efficientnetB0ReID`` wrapper, the scheme of
``daliid_tpu/models/torch_port.py:759-808``): ``features.0.0`` /
``features.0.1`` (stem conv / BN), ``features.{stage}.{repeat}.block.{i}``
with ``.0`` / ``.1`` for each convolution and BN and ``.fc1`` / ``.fc2``
for the squeeze-excitation (1x1 convolutions with bias),
``features.8.0`` / ``features.8.1`` (head) and ``last_bn``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from daliid_tpu_torch.models.norm import TorchBatchNorm
from daliid_tpu_torch.models.resnet import Conv, Dense1x1, pool_features

# (expand, channels, repeats, stride, kernel): the published B0 schedule
_B0_CONFIG = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
BN_EPS = 1e-3


def _conv_bn(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
             act: bool = True, dtype=torch.float32) -> nn.Sequential:
    """Convolution (padding k // 2) → BN (eps 1e-3) → SiLU when ``act``."""
    layers = [Conv(cin, cout, kernel, stride=stride, padding=kernel // 2, groups=groups),
              TorchBatchNorm(cout, eps=BN_EPS, dtype=dtype)]
    if act:
        layers.append(nn.SiLU())
    return nn.Sequential(*layers)


class SqueezeExcite(nn.Module):
    """GAP → fc reduce → SiLU → fc expand → sigmoid, times the input."""

    def __init__(self, channels: int, se_channels: int):
        super().__init__()
        self.fc1 = Dense1x1(channels, se_channels)
        self.fc2 = Dense1x1(se_channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = x.mean(dim=(2, 3), keepdim=True)
        g = self.fc2(F.silu(self.fc1(g)))
        return x * torch.sigmoid(g)


class MBConv(nn.Module):
    """Mobile inverted bottleneck: 1x1 expand → depthwise kxk → SE → 1x1
    project, residual when the stride is 1 and the width holds."""

    def __init__(self, cin: int, cout: int, expand_ratio: int, kernel: int, stride: int,
                 dtype=torch.float32):
        super().__init__()
        mid = cin * expand_ratio
        layers = []
        if expand_ratio != 1:
            layers.append(_conv_bn(cin, mid, 1, dtype=dtype))
        layers += [_conv_bn(mid, mid, kernel, stride, groups=mid, dtype=dtype),
                   SqueezeExcite(mid, max(1, cin // 4)),
                   _conv_bn(mid, cout, 1, act=False, dtype=dtype)]
        self.block = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block(x)
        return y + x if self.residual else y


class EfficientNetB0ReID(nn.Module):
    """EfficientNet-B0 trunk + the reference's ReID head → (B, 1280) f32."""

    def __init__(self, feature: str = "both", dtype: torch.dtype = torch.float32,
                 feature_dim: int = 1280):
        super().__init__()
        if feature not in ("gap", "gmp", "both"):
            raise ValueError(f"feature must be gap|gmp|both, got {feature!r}")
        self.feature = feature
        self.dtype = dtype
        self.feature_dim = feature_dim
        stages = [_conv_bn(3, 32, 3, 2, dtype=dtype)]
        cin = 32
        for expand, ch, repeats, stride, kernel in _B0_CONFIG:
            blocks = []
            for r in range(repeats):
                blocks.append(MBConv(cin, ch, expand, kernel, stride if r == 0 else 1,
                                     dtype=dtype))
                cin = ch
            stages.append(nn.Sequential(*blocks))
        stages.append(_conv_bn(cin, 1280, 1, dtype=dtype))
        self.features = nn.Sequential(*stages)
        self.last_bn = TorchBatchNorm(1280, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x.to(self.dtype))
        return self.last_bn(pool_features(x, self.feature))
