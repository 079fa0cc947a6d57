"""The ResNet ReID family: last-stride-1, GAP+GMP, BN necks, and its heads.

Port of ``daliid_tpu/models/resnet.py`` as ``nn.Module``s: :class:`IBN`
(``:31-46``), :class:`Bottleneck` (``:49-87``), the trunk of
``_resnet_trunk`` (``:90-117``), :class:`ResNet50ReID` (``:120-174``) and
the multi-head models :class:`MultiPartResNet50ReID` (``:177-213``),
:class:`MultiViewResNet50ReID` (``:216-263``) and
:class:`DualResNet50ReID` (``:266-287``). The quirks of the reference
wrapper survive:

- no ReLU after the stem BN (``resnet.py:102``);
- ``last_stride`` 1 on stage 4 by default (``:106``);
- GAP + GMP summed, with ``feature`` = gap, gmp or both (``:147-154``);
- f32 BN necks (``last_bn`` and the heads' own);
- ``stage_sizes`` is a parameter (ResNet-101 is (3, 4, 23, 3));
- ``ibn=True`` is IBN-Net 'a': each bottleneck's ``bn1`` in stages 1-3 is
  an :class:`IBN` block, InstanceNorm on the first half of the channels and
  BN on the second;
- ``seg_attention`` multiplies the trunk's feature map by a segmentation
  mask before pooling when ``forward`` is given one (``resnet50Seg``);
- ``return_feature_map`` returns (f32 feature map, embedding).

The modules run in eval mode (running BN statistics) or, after
``module.train()``, in train mode (batch statistics, running statistics
updated), the JAX package's ``train=True``.

Layout: inputs are NCHW-logical in ``channels_last`` memory. Parameters are
f32; convolutions run in the compute ``dtype`` (bf16 on the GPU by default)
through ``torch.nn.functional.conv2d`` (cuDNN). Padding matches flax's: the
explicit 3 and 1 of the 7x7 and 3x3 convolutions, and flax's ``'SAME'`` on
the 1x1 convolutions, which for a 1x1 kernel is no padding at any stride
and any input size. ``state_dict`` keys are the reference's torch keys
(``conv1``, ``layer3.2.bn1.running_mean``, ``layer1.0.bn1.IN.weight``,
``layer4.0.downsample.0``, ``last_bn``, ...); the multi-head models' heads
take their flax names (``upper_bn``, ``spatial_gate``, ``id_bn``, ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from daliid_tpu_torch.models.norm import InstanceNorm, TorchBatchNorm


class Conv(nn.Conv2d):
    """Convolution that runs in its input's dtype (f32 weights, and bias,
    cast at call time) and keeps ``channels_last``; bias-free unless asked,
    as flax's ``use_bias`` default is for the attention gates. ``kernel``
    and ``padding`` take an int or an (h, w) pair (symmetric padding, as
    flax's explicit integer padding); ``groups`` = channels is a depthwise
    convolution (flax's ``feature_group_count``)."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0,
                 bias: bool = False, groups: int = 1):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=bias,
                         groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(dtype=x.dtype, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, self.stride, self.padding, 1, self.groups)


class Dense1x1(Conv):
    """A flax ``nn.Dense`` over the channel axis, held as a 1x1 convolution
    with bias so that its weights keep the reference's torch keys (OSNet's
    channel gate, EfficientNet's squeeze-excitation). The int8 quantizer
    treats it as the Dense layer it is in the JAX package
    (``ops/quantize.py::quant_layers``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1, bias=True)


class IBN(nn.Module):
    """Instance-Batch Norm: :class:`InstanceNorm` on the first half of the
    channels (``IN``), torch-semantics BN on the second (``BN``)."""

    def __init__(self, planes: int, dtype=torch.float32):
        super().__init__()
        self.half = planes // 2
        self.IN = InstanceNorm(self.half, dtype=dtype)
        self.BN = TorchBatchNorm(planes - self.half, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.IN(x[:, :self.half]), self.BN(x[:, self.half:])], dim=1)
        return y.contiguous(memory_format=torch.channels_last)


class Bottleneck(nn.Module):
    """torchvision-v1.5 bottleneck: 1x1 → 3x3(stride) → 1x1, projection
    shortcut on a change of shape; ``ibn`` makes ``bn1`` an :class:`IBN`."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, ibn: bool = False,
                 dtype=torch.float32):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = Conv(cin, planes, 1)
        self.bn1 = IBN(planes, dtype=dtype) if ibn else TorchBatchNorm(planes, dtype=dtype)
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


def pool_features(x: torch.Tensor, feature: str = "both") -> torch.Tensor:
    """GAP, GMP or their sum (``feature``) over H and W in the compute
    dtype, then f32."""
    if feature == "gap":
        pooled = x.mean(dim=(2, 3))
    elif feature == "gmp":
        pooled = x.amax(dim=(2, 3))
    else:
        pooled = x.mean(dim=(2, 3)) + x.amax(dim=(2, 3))
    return pooled.float()


class _ResNetTrunk(nn.Module):
    """The shared trunk: stem without ReLU, max pool, 4 bottleneck stages
    (IBN in stages 1-3 when ``ibn``) → 2048 channels."""

    def __init__(self, stage_sizes: Sequence[int], last_stride: int, ibn: bool,
                 dtype: torch.dtype, feature_dim: int):
        super().__init__()
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
                blocks.append(Bottleneck(cin, planes, stride=s if b == 0 else 1,
                                         ibn=ibn and stage < 4, dtype=dtype))
                cin = planes * Bottleneck.expansion
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.channels = cin

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = self.bn1(self.conv1(x))
        # no stem ReLU — matches the reference forward
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(1, self.num_stages + 1):
            x = getattr(self, f"layer{stage}")(x)
        return x


class ResNet50ReID(_ResNetTrunk):
    """ResNet trunk + ReID head: ``forward(x)`` → (B, 2048) f32 embedding."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), feature: str = "both",
                 last_stride: int = 1, ibn: bool = False, seg_attention: bool = False,
                 return_feature_map: bool = False, dtype: torch.dtype = torch.float32,
                 feature_dim: int = 2048):
        super().__init__(stage_sizes, last_stride, ibn, dtype, feature_dim)
        if feature not in ("gap", "gmp", "both"):
            raise ValueError(f"feature must be gap|gmp|both, got {feature!r}")
        self.feature = feature
        self.seg_attention = seg_attention
        self.return_feature_map = return_feature_map
        self.last_bn = TorchBatchNorm(self.channels, dtype=torch.float32)

    def forward(self, x: torch.Tensor, seg_mask: torch.Tensor | None = None):
        """``seg_mask`` (with ``seg_attention``): broadcastable to the
        feature map, NCHW-logical, e.g. (B, 1, h, w)."""
        x = feature_map = self.trunk(x)
        if self.seg_attention and seg_mask is not None:
            x = x * seg_mask.to(x.dtype)
        out = self.last_bn(pool_features(x, self.feature))
        if self.return_feature_map:
            return feature_map.float(), out
        return out


class MultiPartResNet50ReID(_ResNetTrunk):
    """Horizontal-stripe part heads: the trunk's map split into upper,
    middle and lower thirds of its rows (each the whole map when it has
    fewer than 3 rows), each pooled GAP+GMP into its own BN neck, plus the
    global head → (upper, middle, lower, global), each (B, 2048)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), last_stride: int = 1,
                 dtype: torch.dtype = torch.float32, feature_dim: int = 2048):
        super().__init__(stage_sizes, last_stride, False, dtype, feature_dim)
        for name in ("upper_bn", "middle_bn", "lower_bn", "last_bn"):
            self.add_module(name, TorchBatchNorm(self.channels, dtype=torch.float32))

    def forward(self, x: torch.Tensor):
        feats = self.trunk(x)
        h = feats.shape[2]
        if h >= 3:
            bands = (feats[:, :, : h // 3], feats[:, :, h // 3: 2 * h // 3],
                     feats[:, :, 2 * h // 3:], feats)
        else:
            bands = (feats,) * 4
        return tuple(bn(pool_features(f)) for f, bn in zip(
            bands, (self.upper_bn, self.middle_bn, self.lower_bn, self.last_bn)))


class MultiViewResNet50ReID(_ResNetTrunk):
    """Global, spatial-attention and channel-attention heads: a 1x1 sigmoid
    spatial gate, and a squeeze/expand sigmoid channel gate over
    concat(GAP, GMP); the gates' convolutions have biases (flax's default)
    → (global, spatial, channel), each (B, 2048)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), last_stride: int = 1,
                 dtype: torch.dtype = torch.float32, feature_dim: int = 2048):
        super().__init__(stage_sizes, last_stride, False, dtype, feature_dim)
        ch = self.channels
        self.spatial_gate = Conv(ch, 1, 1, bias=True)
        self.channel_squeeze = Conv(2 * ch, ch // 2, 1, bias=True)
        self.channel_expand = Conv(ch // 2, ch, 1, bias=True)
        for name in ("last_bn", "spatial_bn", "channel_bn"):
            self.add_module(name, TorchBatchNorm(ch, dtype=torch.float32))

    def forward(self, x: torch.Tensor):
        feats = self.trunk(x)
        space_att = torch.sigmoid(self.spatial_gate(feats))
        gp = torch.cat([feats.mean(dim=(2, 3)), feats.amax(dim=(2, 3))], dim=1)[:, :, None, None]
        channel_att = torch.sigmoid(self.channel_expand(F.relu(self.channel_squeeze(gp))))
        return (self.last_bn(pool_features(feats)),
                self.spatial_bn(pool_features(feats * space_att)),
                self.channel_bn(pool_features(feats * channel_att)))


class DualResNet50ReID(_ResNetTrunk):
    """A shared trunk with separate identity and bias BN necks over one
    GAP+GMP pooling → (concat (B, 4096), id_fv, bias_fv)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), last_stride: int = 1,
                 dtype: torch.dtype = torch.float32, feature_dim: int = 4096):
        super().__init__(stage_sizes, last_stride, False, dtype, feature_dim)
        self.id_bn = TorchBatchNorm(self.channels, dtype=torch.float32)
        self.bias_bn = TorchBatchNorm(self.channels, dtype=torch.float32)

    def forward(self, x: torch.Tensor):
        pooled = pool_features(self.trunk(x))
        id_fv, bias_fv = self.id_bn(pooled), self.bias_bn(pooled)
        return torch.cat([id_fv, bias_fv], dim=1), id_fv, bias_fv
