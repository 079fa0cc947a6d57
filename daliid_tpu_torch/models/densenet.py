"""DenseNet-121 ReID backbone, with the optional train-time classifier.

Port of ``daliid_tpu/models/densenet.py``: :class:`DenseLayer`
(``:26-40``), :class:`Transition` (``:43-54``) and :class:`DenseNet121ReID`
(``:57-96``). Dense blocks of ``block_sizes`` layers (6/12/24/16, growth
32), each layer BN → ReLU → 1x1 (4·growth) → BN → ReLU → 3x3 (growth)
concatenated to its input, transitions halving the channels and pooling
2x2; the final BN → ReLU; GAP + GMP summed and concatenated with itself
(1024 → 2048, the reference's ``cat([x, x])``) into an f32 BN neck.

With ``num_classes > 0`` the model in train mode returns ``(embedding,
logits)``: the logits come from the L2-normalized embedding (eps 1e-12)
through a bias-free f32 linear layer (``:89-95``). In eval mode it returns
the embedding alone, so mining and validation see a plain tensor.

``state_dict`` keys are the reference checkpoint's (torchvision
``densenet121.features`` under the wrapper's ``model_base``, the scheme of
``daliid_tpu/models/torch_port.py:575-624``): ``model_base.conv0``,
``model_base.denseblock1.denselayer1.norm1``,
``model_base.transition1.conv``, ``model_base.norm5``, ``last_bn`` and
``classification``. BN epsilon is 1e-5 throughout.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from daliid_tpu_torch.models.norm import TorchBatchNorm
from daliid_tpu_torch.models.resnet import Conv


class DenseLayer(nn.Module):
    """BN → ReLU → 1x1 (4·growth) → BN → ReLU → 3x3 (growth), concat."""

    def __init__(self, cin: int, growth: int = 32, dtype=torch.float32):
        super().__init__()
        self.norm1 = TorchBatchNorm(cin, dtype=dtype)
        self.conv1 = Conv(cin, 4 * growth, 1)
        self.norm2 = TorchBatchNorm(4 * growth, dtype=dtype)
        self.conv2 = Conv(4 * growth, growth, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1).contiguous(memory_format=torch.channels_last)


class Transition(nn.Module):
    """BN → ReLU → 1x1 halving the channels → 2x2 average pool."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.norm = TorchBatchNorm(cin, dtype=dtype)
        self.conv = Conv(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, stride=2)


class _Features(nn.Module):
    """torchvision's ``densenet121.features``: stem, dense blocks and
    transitions, the final BN (``norm5``)."""

    def __init__(self, block_sizes: Sequence[int], growth: int, dtype):
        super().__init__()
        self.conv0 = Conv(3, 64, 7, stride=2, padding=3)
        self.norm0 = TorchBatchNorm(64, dtype=dtype)
        ch = 64
        for bi, num_layers in enumerate(block_sizes, start=1):
            block = nn.Module()
            for li in range(num_layers):
                block.add_module(f"denselayer{li + 1}", DenseLayer(ch, growth, dtype=dtype))
                ch += growth
            self.add_module(f"denseblock{bi}", block)
            if bi < len(block_sizes):
                self.add_module(f"transition{bi}", Transition(ch, ch // 2, dtype=dtype))
                ch //= 2
        self.norm5 = TorchBatchNorm(ch, dtype=dtype)
        self.block_sizes = tuple(block_sizes)
        self.channels = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm0(self.conv0(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for bi, num_layers in enumerate(self.block_sizes, start=1):
            block = getattr(self, f"denseblock{bi}")
            for li in range(num_layers):
                x = getattr(block, f"denselayer{li + 1}")(x)
            if bi < len(self.block_sizes):
                x = getattr(self, f"transition{bi}")(x)
        return self.norm5(x)


class DenseNet121ReID(nn.Module):
    """DenseNet-121 trunk + the reference's ReID head → (B, 2048) f32, and
    in train mode with ``num_classes > 0`` the logits beside it."""

    def __init__(self, block_sizes: Sequence[int] = (6, 12, 24, 16), growth: int = 32,
                 num_classes: int = 0, dtype: torch.dtype = torch.float32,
                 feature_dim: int = 2048):
        super().__init__()
        self.block_sizes = tuple(block_sizes)
        self.growth = growth
        self.num_classes = num_classes
        self.dtype = dtype
        self.feature_dim = feature_dim
        self.model_base = _Features(self.block_sizes, growth, dtype)
        width = 2 * self.model_base.channels
        self.last_bn = TorchBatchNorm(width, dtype=torch.float32)
        if num_classes:
            self.classification = nn.Linear(width, num_classes, bias=False)

    def forward(self, x: torch.Tensor):
        x = F.relu(self.model_base(x.to(self.dtype)))
        pooled = x.mean(dim=(2, 3)) + x.amax(dim=(2, 3))
        pooled = torch.cat([pooled, pooled], dim=1).float()  # 1024 → 2048
        out = self.last_bn(pooled)
        if self.num_classes and self.training:
            normed = out / (torch.linalg.vector_norm(out, dim=1, keepdim=True) + 1e-12)
            return out, self.classification(normed)
        return out
