"""Backbone factory.

Port of ``daliid_tpu/models/factory.py``: :class:`ModelBundle`, the
ResNet family ``resnet50``, ``resnet50_gap``, ``resnet50Seg``,
``resnet50IBN``, ``resnet101IBN``, ``dualresnet50``, ``multipart_resnet50``
and ``multiview_resnet50`` (``:72-109``, ``:223-238``), the rest of the CNN
zoo ``osnet``, ``densenet121`` (with ``num_classes``), ``efficientnetB0``
and ``inceptionV3`` (``:107-130``), the ViT family ``vit``,
``vit_small``, ``deit_small``, ``tiny_vit_smoke``, ``transreid_jpm`` and
``transreid`` (``:131-197``): all 18 names of the JAX registry. Also the
flag sets of ``:50-61``,
:func:`get_model` (``:200-220``), :func:`build_ensembles` (``:241-253``)
and :func:`build_model_pair` (``:256-266``). As in the JAX package every
factory takes ``**kw`` and ignores what it does not use; the CLIs check
the flags against the sets below.

``use_fused_attention=True`` is the JAX factories' ``use_pallas_attention``:
the ViT family's attention goes through the hand-written kernel K4 instead
of ``scaled_dot_product_attention``. ``remat`` (``models/vit.py::REMAT_MODES``)
checkpoints the transformer blocks of the ``REMAT_MODELS``.

Weights are initialized from an explicit ``torch.Generator``, in the
families of flax's defaults: every convolution and linear kernel ~ N(0,
1/fan_in) (LeCun-normal), zero biases, unit scale and zero bias in BN and
LayerNorm, zero running mean and unit running variance; the ViT's cls,
position and SIE tokens ~ truncated normal(0.02) at +-2 std; the JPM
classifiers ~ N(0, 0.001).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from daliid_tpu_torch.models.densenet import DenseNet121ReID
from daliid_tpu_torch.models.efficientnet import EfficientNetB0ReID
from daliid_tpu_torch.models.inception import InceptionV3ReID
from daliid_tpu_torch.models.osnet import OSNetReID
from daliid_tpu_torch.models.resnet import (
    DualResNet50ReID,
    MultiPartResNet50ReID,
    MultiViewResNet50ReID,
    ResNet50ReID,
)
from daliid_tpu_torch.models.transreid_jpm import TransReIDJPM
from daliid_tpu_torch.models.vit import (
    ViTReID,
    VisionTransformer,
    deit_small_reid,
    transreid_base,
    vit_base_reid,
    vit_small_reid,
)


@dataclasses.dataclass
class ModelBundle:
    """A backbone module on its device, and its embedding width."""

    module: nn.Module
    feature_dim: int
    name: str


MODEL_REGISTRY: Dict[str, Callable[..., tuple]] = {}

# the models whose factories use these keywords (the CLIs refuse the flags
# for the others, which would swallow them)
MARGIN_HEAD_MODELS = frozenset({"transreid_jpm"})
SIE_MODELS = frozenset({"transreid", "transreid_jpm"})
GELU_APPROX_MODELS = frozenset({"vit", "vit_small", "deit_small", "transreid", "transreid_jpm"})
# the ViTReID family (one state_dict scheme: base.* + bottleneck)
VIT_MODELS = frozenset({"vit", "vit_small", "deit_small", "transreid", "tiny_vit_smoke"})
# the models whose factories pass ``remat=`` to the transformer blocks
REMAT_MODELS = frozenset({"vit", "vit_small", "deit_small", "transreid", "transreid_jpm"})
# the models whose forward returns a tuple of head embeddings
MULTIHEAD_MODELS = frozenset({"dualresnet50", "multipart_resnet50", "multiview_resnet50"})


def register_model(name: str):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn

    return deco


@register_model("resnet50")
def _resnet50(dtype=torch.float32, feature="both", **kw):
    return ResNet50ReID(dtype=dtype, feature=feature), 2048


@register_model("resnet50_gap")
def _resnet50_gap(dtype=torch.float32, **kw):
    return ResNet50ReID(dtype=dtype, feature="gap"), 2048


@register_model("resnet50Seg")
def _resnet50_seg(dtype=torch.float32, **kw):
    """Seg-mask attention variant (Encoders.py:50-71, 356-401)."""
    return ResNet50ReID(dtype=dtype, seg_attention=True), 2048


@register_model("resnet50IBN")
def _resnet50_ibn(dtype=torch.float32, **kw):
    """IBN-Net-a ResNet-50 (Encoders.py:73-97, 462-531)."""
    return ResNet50ReID(dtype=dtype, ibn=True), 2048


@register_model("resnet101IBN")
def _resnet101_ibn(dtype=torch.float32, **kw):
    """IBN-Net-a ResNet-101 (Encoders.py:99-123, 534-603)."""
    return ResNet50ReID(dtype=dtype, ibn=True, stage_sizes=(3, 4, 23, 3)), 2048


@register_model("dualresnet50")
def _dual_resnet50(dtype=torch.float32, **kw):
    """Two-head (id, bias) ResNet-50 (Encoders.py:404-459)."""
    return DualResNet50ReID(dtype=dtype), 4096


@register_model("multipart_resnet50")
def _multipart_resnet50(dtype=torch.float32, **kw):
    """Horizontal-stripe part heads (getFeatures.py:110-156 consumer)."""
    return MultiPartResNet50ReID(dtype=dtype), 2048


@register_model("multiview_resnet50")
def _multiview_resnet50(dtype=torch.float32, **kw):
    """Global/spatial/channel attention heads (getFeatures.py:202-241)."""
    return MultiViewResNet50ReID(dtype=dtype), 2048


@register_model("osnet")
def _osnet(dtype=torch.float32, feature="both", **kw):
    """OSNet-x1.0 (Encoders.py:125-146, 642-684)."""
    return OSNetReID(dtype=dtype, feature=feature), 512


@register_model("densenet121")
def _densenet121(dtype=torch.float32, num_classes=0, **kw):
    """DenseNet-121 (Encoders.py:148-169, 606-639)."""
    return DenseNet121ReID(dtype=dtype, num_classes=num_classes), 2048


@register_model("efficientnetB0")
def _efficientnet_b0(dtype=torch.float32, feature="both", **kw):
    """EfficientNet-B0 (Encoders.py:218-239, 831-864)."""
    return EfficientNetB0ReID(dtype=dtype, feature=feature), 1280


@register_model("inceptionV3")
def _inception_v3(dtype=torch.float32, feature="both", **kw):
    """Inception-V3 (Encoders.py:171-192, 686-763)."""
    return InceptionV3ReID(dtype=dtype, feature=feature), 2048


@register_model("vit")
def _vit(dtype=torch.float32, img_size=(256, 128), gelu_approx=False,
         use_fused_attention=False, remat="none", **kw):
    return vit_base_reid(dtype=dtype, img_size=tuple(img_size), gelu_approx=gelu_approx,
                         use_fused_attention=use_fused_attention, remat=remat), 768


@register_model("vit_small")
def _vit_small(dtype=torch.float32, img_size=(256, 128), gelu_approx=False,
               use_fused_attention=False, remat="none", **kw):
    """The reference's vit_small (vit_pytorch.py:461-468): 768/8/8, mlp 3,
    no qkv bias, qk_scale 768^-0.5."""
    return vit_small_reid(dtype=dtype, img_size=tuple(img_size), gelu_approx=gelu_approx,
                          use_fused_attention=use_fused_attention, remat=remat), 768


@register_model("deit_small")
def _deit_small(dtype=torch.float32, img_size=(256, 128), gelu_approx=False,
                use_fused_attention=False, remat="none", **kw):
    """DeiT-small (vit_pytorch.py:470-476)."""
    return deit_small_reid(dtype=dtype, img_size=tuple(img_size), gelu_approx=gelu_approx,
                           use_fused_attention=use_fused_attention, remat=remat), 384


@register_model("tiny_vit_smoke")
def _tiny_vit_smoke(dtype=torch.float32, img_size=(32, 16), **kw):
    """One-block 32-d ViT for pipeline smoke runs (not a reference model)."""
    return ViTReID(img_size=tuple(img_size), patch_size=8, patch_stride=8, embed_dim=32,
                   depth=1, num_heads=2, drop_path_rate=0.0, dtype=dtype), 32


@register_model("transreid_jpm")
def _transreid_jpm(dtype=torch.float32, img_size=(256, 128), sie_cameras=0, sie_views=0,
                   sie_coef=1.5, num_classes=0, id_loss_type="softmax", margin_s=None,
                   margin_m=None, gelu_approx=False, use_fused_attention=False, remat="none",
                   **kw):
    """TransReID with the jigsaw patch module (make_models.py:221-389)."""
    return TransReIDJPM(
        img_size=tuple(img_size), sie_cameras=sie_cameras, sie_views=sie_views,
        sie_coef=sie_coef, num_classes=num_classes, id_loss_type=id_loss_type,
        margin_s=margin_s, margin_m=margin_m, gelu_approx=gelu_approx,
        use_fused_attention=use_fused_attention, remat=remat, dtype=dtype), 5 * 768


@register_model("transreid")
def _transreid(dtype=torch.float32, img_size=(256, 128), sie_cameras=0, sie_views=0,
               sie_coef=1.5, gelu_approx=False, use_fused_attention=False, remat="none", **kw):
    return transreid_base(img_size=tuple(img_size), sie_cameras=sie_cameras,
                          sie_views=sie_views, sie_coef=sie_coef, gelu_approx=gelu_approx,
                          use_fused_attention=use_fused_attention, remat=remat,
                          dtype=dtype), 768


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in flax's families (see the module docstring)."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = 0.001 if name.startswith("classifier") else 1.0 / math.sqrt(fan_in)
            m.weight.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, VisionTransformer):
            for p in (m.cls_token, m.pos_embed, getattr(m, "sie_embed", None)):
                if p is not None:
                    nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=generator)


def check_model_name(name: str) -> None:
    """Raise for a model the port does not have."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown or not yet ported model {name!r}; "
                       f"ported: {sorted(MODEL_REGISTRY)}")


def get_model(name: str, generator: torch.Generator | None = None, img_size=(256, 128),
              dtype: torch.dtype = torch.float32, device="cpu", **kw) -> ModelBundle:
    """Build one backbone in eval mode on ``device``; weights from
    ``generator`` (seed 12 if None). ``img_size`` sets the ViT family's
    patch grid; the ResNet takes any input size."""
    check_model_name(name)
    module, feature_dim = MODEL_REGISTRY[name](dtype=dtype, img_size=img_size, **kw)
    if generator is None:
        generator = torch.Generator().manual_seed(12)
    init_weights(module, generator)
    module = module.to(device).eval()
    return ModelBundle(module=module, feature_dim=feature_dim, name=name)


def build_model_pair(name: str, generator: torch.Generator | None = None, img_size=(256, 128),
                     dtype: torch.dtype = torch.float32, device="cpu", **kw):
    """(online, momentum) pair with identical initial weights: the momentum
    model is a copy of the online one (the weight sync at
    ``Encoders.py:36-44``). Both come back in eval mode; the trainer puts
    the online model in train mode."""
    online = get_model(name, generator, img_size=img_size, dtype=dtype, device=device, **kw)
    momentum = ModelBundle(module=copy.deepcopy(online.module), feature_dim=online.feature_dim,
                           name=name)
    return online, momentum


def build_ensembles(generator: torch.Generator | None = None,
                    names=("resnet50", "osnet", "densenet121"), img_size=(256, 128),
                    dtype: torch.dtype = torch.float32, device="cpu"):
    """The reference's three-backbone ensemble (``getEnsembles``,
    ``Encoders.py:245-301``): one synced (online, momentum) pair per name.
    Pair ``i`` draws its weights from a generator of its own, seeded from
    ``generator``'s seed and ``i`` (the JAX package's ``fold_in(rng, i)``),
    so the pairs differ whatever the backbones."""
    base = 12 if generator is None else generator.initial_seed()
    pairs = []
    for i, name in enumerate(names):
        seed = int(np.random.SeedSequence([base, i]).generate_state(1, np.uint64)[0] >> 1)
        pairs.append(build_model_pair(name, torch.Generator().manual_seed(seed),
                                      img_size=img_size, dtype=dtype, device=device))
    return pairs
