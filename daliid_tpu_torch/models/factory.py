"""Backbone factory.

Port of ``daliid_tpu/models/factory.py``: :class:`ModelBundle`,
:func:`get_model` for ``resnet50`` and ``resnet50_gap`` (``:72-81``,
``:200-220``) and :func:`build_model_pair` (``:256-266``). The other zoo
entries are not ported yet. Weights are
initialized from an explicit ``torch.Generator``: LeCun-normal convolution
kernels (flax ``nn.Conv``'s default family), unit BN scale, zero BN bias,
zero running mean and unit running variance.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict

import torch
from torch import nn

from daliid_tpu_torch.models.resnet import ResNet50ReID


@dataclasses.dataclass
class ModelBundle:
    """A backbone module on its device, and its embedding width."""

    module: nn.Module
    feature_dim: int
    name: str


MODEL_REGISTRY: Dict[str, Callable[..., tuple]] = {}


def register_model(name: str):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn

    return deco


@register_model("resnet50")
def _resnet50(dtype=torch.float32, feature="both", **kw):
    return ResNet50ReID(dtype=dtype, feature=feature, **kw), 2048


@register_model("resnet50_gap")
def _resnet50_gap(dtype=torch.float32, **kw):
    return ResNet50ReID(dtype=dtype, feature="gap", **kw), 2048


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: every conv kernel ~ N(0, 1/fan_in)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)


def get_model(name: str, generator: torch.Generator | None = None,
              dtype: torch.dtype = torch.float32, device="cpu", **kw) -> ModelBundle:
    """Build one backbone in eval mode on ``device``; weights from
    ``generator`` (seed 12 if None). The ResNet takes any input size, so
    unlike the JAX ``get_model`` no ``img_size`` is needed."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown or not yet ported model {name!r}; "
                       f"ported: {sorted(MODEL_REGISTRY)}")
    module, feature_dim = MODEL_REGISTRY[name](dtype=dtype, **kw)
    if generator is None:
        generator = torch.Generator().manual_seed(12)
    init_weights(module, generator)
    module = module.to(device).eval()
    return ModelBundle(module=module, feature_dim=feature_dim, name=name)


def build_model_pair(name: str, generator: torch.Generator | None = None,
                     dtype: torch.dtype = torch.float32, device="cpu", **kw):
    """(online, momentum) pair with identical initial weights: the momentum
    model is a copy of the online one (the weight sync at
    ``Encoders.py:36-44``). Both come back in eval mode; the trainer puts
    the online model in train mode."""
    online = get_model(name, generator, dtype=dtype, device=device, **kw)
    momentum = ModelBundle(module=copy.deepcopy(online.module), feature_dim=online.feature_dim,
                           name=name)
    return online, momentum
