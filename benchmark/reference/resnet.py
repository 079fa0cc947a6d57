"""ResNet-50 re-ID encoder, as a plain function of its parameters.

He et al., *Deep Residual Learning* (arXiv:1512.03385), torchvision's v1.5
bottleneck (the stride on the 3x3), with the re-ID changes DaliID trains:
no ReLU after the stem's BN, last stride 1, GAP + GMP summed, and a BN neck
over the 2048-d pooled feature. Parameters and BN statistics are one dict
keyed by the reference torch names (``conv1.weight``, ``layer3.2.bn1.
running_mean``, ``layer4.0.downsample.0.weight``, ``last_bn.bias``, ...).
Train mode normalizes with the batch's biased variance and moves the
running statistics by 0.1 (the unbiased variance), as torch's BN does.

The widths come from the configuration (``benchmark/configs/*.json``):
``stage_sizes`` (blocks a stage), ``stage_widths`` (the bottleneck's
planes), ``expansion`` and ``last_stride``; the first stage keeps the
stem's stride and the middle ones halve the map.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision
from benchmark.roofline import models

# ResNet-50 with the re-ID head, as ``benchmark/configs/resnet50.json`` states it
RESNET50 = {"img_size": [256, 128], "stage_sizes": [3, 4, 6, 3],
            "stage_widths": [64, 128, 256, 512], "expansion": 4, "last_stride": 1}


def stages(cfg: dict) -> list:
    """[(blocks, planes, stride)] of the four stages."""
    strides = [1] + [2] * (len(cfg["stage_sizes"]) - 2) + [cfg["last_stride"]]
    return list(zip(cfg["stage_sizes"], cfg["stage_widths"], strides))


def _bn_spec(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,), "ones"), (f"{name}.bias", (c,), "zeros"),
            (f"{name}.running_mean", (c,), "zeros"), (f"{name}.running_var", (c,), "ones")]


def spec(cfg: dict) -> list:
    """[(name, shape, init)] of every parameter and statistic; ``init`` is
    ``fan_in`` (normal, std 1/sqrt(fan in)), ``ones`` or ``zeros``."""
    stem, exp = cfg["stage_widths"][0], cfg["expansion"]
    out = [("conv1.weight", (stem, 3, 7, 7), "fan_in")] + _bn_spec("bn1", stem)
    cin = stem
    for s, (n_blocks, planes, _) in enumerate(stages(cfg), start=1):
        for b in range(n_blocks):
            p = f"layer{s}.{b}"
            out += [(f"{p}.conv1.weight", (planes, cin, 1, 1), "fan_in")] + _bn_spec(f"{p}.bn1",
                                                                                    planes)
            out += [(f"{p}.conv2.weight", (planes, planes, 3, 3), "fan_in")] + _bn_spec(
                f"{p}.bn2", planes)
            out += [(f"{p}.conv3.weight", (planes * exp, planes, 1, 1), "fan_in")]
            out += _bn_spec(f"{p}.bn3", planes * exp)
            if b == 0:
                out += [(f"{p}.downsample.0.weight", (planes * exp, cin, 1, 1), "fan_in")]
                out += _bn_spec(f"{p}.downsample.1", planes * exp)
            cin = planes * exp
    return out + _bn_spec("last_bn", cin)


def _bn(P: dict, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    return F.batch_norm(x, P[f"{name}.running_mean"], P[f"{name}.running_var"],
                        P[f"{name}.weight"], P[f"{name}.bias"], training=train, momentum=0.1,
                        eps=1e-5)


def _conv(P: dict, name: str, x: torch.Tensor, prec: Precision, stride=1, padding=0):
    return prec.grad(F.conv2d(prec(x), prec(P[f"{name}.weight"]), None, stride, padding))


def forward(cfg: dict, P: dict, x: torch.Tensor, train: bool = False,
            prec: Precision | None = None, generator=None) -> torch.Tensor:
    """(B, 3, H, W) normalized float32 images → (B, feature dim) embeddings."""
    prec = prec or Precision()
    x = _bn(P, "bn1", _conv(P, "conv1", x, prec, 2, 3), train)
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for s, (n_blocks, _, stride) in enumerate(stages(cfg), start=1):
        for b in range(n_blocks):
            p = f"layer{s}.{b}"
            st = stride if b == 0 else 1
            y = F.relu(_bn(P, f"{p}.bn1", _conv(P, f"{p}.conv1", x, prec), train))
            y = F.relu(_bn(P, f"{p}.bn2", _conv(P, f"{p}.conv2", y, prec, st, 1), train))
            y = _bn(P, f"{p}.bn3", _conv(P, f"{p}.conv3", y, prec), train)
            if b == 0:
                x = _bn(P, f"{p}.downsample.1", _conv(P, f"{p}.downsample.0", x, prec, st),
                        train)
            x = F.relu(y + x)
    pooled = x.mean(dim=(2, 3)) + x.amax(dim=(2, 3))
    return _bn(P, "last_bn", pooled, train)


def flops(cfg: dict, train: bool = False) -> float:
    """Model FLOPs of one image's forward (the head has no classifier)."""
    h, w = cfg["img_size"]
    return models.resnet_reid(h, w, stages(cfg), cfg["expansion"])


def attention(cfg: dict) -> list:
    """No attention: K4 has nothing to read."""
    return []
