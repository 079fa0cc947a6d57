"""Weight carry between the port and the JAX package and the reference:
JAX variables, JAX ``.npz`` files and the reference's torch checkpoints ↔
the port's ``state_dict``.

The port's ``state_dict`` keys are the reference's torch keys, the schemes
that ``daliid_tpu/models/torch_port.py`` emits: ``resnet50_reid_to_torch_keys``
(``:901-932``) and ``resnet_ibn_reid_to_torch_keys`` (``:670-680``) for the
ResNets (a multi-head model's heads under their flax names),
``vit_reid_to_torch_keys(wrapper='base')`` (``:413``) for the ViTReID
family (``base.*`` + the ``bottleneck`` neck), ``transreid_jpm_to_torch_keys``
(``:496``) for TransReID-JPM, and the rest of the CNN zoo: OSNet
(``:508-572``), DenseNet-121 (``:575-624``), Inception-V3 (``:680-757``)
and EfficientNet-B0 (``:759-808``), whose gates and squeeze-excitations
are 1x1 convolutions with bias in torch and Dense layers in flax. Every
entry point dispatches on the model name, as ``variables_from_torch`` does
(``:810-846``):

- :func:`variables_from_jax` turns the JAX package's ``{'params',
  'batch_stats'}`` tree of numpy arrays into that ``state_dict``:
  convolution kernels HWIO → OIHW, Dense kernels (in, out) → Linear
  weights (out, in), LayerNorm and BN ``scale`` → ``weight``, BN
  ``mean/var`` → ``running_mean/var``, the ViT's ``cls_token``,
  ``pos_embed`` and ``sie_embed`` as they are;
- :func:`params_from_jax` does the same for a tree of the params' structure
  alone: the params, or optax's Adam moments ``mu`` and ``nu``;
- :func:`quant_scales_from_jax` maps the JAX package's int8 calibration
  scales, keyed by flax module path, to the port's module names;
- :func:`read_jax_npz` reads the ``.npz`` that the JAX package's
  ``train/checkpoint.py::save_variables`` writes, whose keys are
  ``jax.tree_util.keystr`` paths such as
  ``['params']['layer1_0']['conv1']['kernel']``, parsed here as strings;
- :func:`variables_to_jax` is the inverse of :func:`variables_from_jax`,
  through the same key tables (:func:`_entries_of` reads a model's
  structure from either side), and :func:`state_to_torch` writes the
  reference scheme of the JAX package's ``variables_to_torch``: together
  they are ``cli/export.py``'s two directions;
- :func:`state_from_torch` reads a reference ``state_dict`` (the ResNets'
  already has the port's layout once DataParallel's ``module.`` prefix is
  dropped, and the IBN-Net ``fc.`` head, ``:662-667``; the multi-head
  ResNets' heads have no reference keys, so a checkpoint without them is
  refused): torchvision ``vit_b_16`` keys are renamed to TransReID's
  (``_normalize_torchvision_vit_keys``, ``:287-316``), a bare backbone gets
  the ``base.`` prefix and an identity neck, JPM's unmapped
  ``base.blocks.{depth-1}`` and ``base.norm`` are dropped (``:476``), a
  margin-head checkpoint's missing local classifiers are filled
  (``:463-473``), and the position embedding is resized to the module's
  grid (``:478-492``); the OSNet, DenseNet, Inception and EfficientNet
  checkpoints have the port's keys once the ImageNet heads that their
  wrappers keep unused are dropped, and a DenseNet classifier is dropped
  for a model built without one (``num_classes=0``, as evaluation builds
  it).

``swin_base`` exists only in the port (``factory.PORT_ONLY_MODELS``): every
conversion to or from the JAX package's layout (the key tables, so
:func:`variables_to_jax`, :func:`variables_from_jax`, :func:`params_from_jax`
and :func:`quant_scales_from_jax`, hence ``.npz`` files) and
:func:`state_to_torch`, which writes the JAX package's reference scheme,
refuse it by name; :func:`state_from_torch` takes its port-written
``state_dict`` as it is.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from daliid_tpu_torch.models.efficientnet import _B0_CONFIG
from daliid_tpu_torch.models.factory import VIT_MODELS, jax_layout_refusal
from daliid_tpu_torch.models.vit import resize_pos_embed

_KEYSTR_PART = re.compile(r"\['([^']*)'\]")


def strip_module_prefix(state_dict: Mapping[str, object]) -> Dict[str, object]:
    """Drop DataParallel's ``module.`` key prefix."""
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in state_dict.items()}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference torch ``state_dict`` pickle → its tensors, ``module.``
    dropped, without the ``num_batches_tracked`` counters eval does not
    read."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: torch.as_tensor(v) for k, v in strip_module_prefix(sd).items()
            if not k.endswith("num_batches_tracked")}


def read_jax_npz(path: str) -> Dict[str, object]:
    """The JAX package's ``save_variables`` ``.npz`` → nested dict of numpy
    arrays (``{'params': {...}, 'batch_stats': {...}}``)."""
    tree: Dict[str, object] = {}
    with np.load(path) as data:
        for key in data.files:
            parts = _KEYSTR_PART.findall(key)
            if not parts or "".join(f"['{p}']" for p in parts) != key:
                raise ValueError(f"not a keystr path of string keys: {key!r}")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


# ------------------------------------------------------------ key tables
# (torch prefix, path of the flax node, kind): kinds are conv, dense, ln
# (LayerNorm), bn, raw (the array under its own key) and dense_conv1x1 (a
# flax Dense that is a 1x1 convolution with bias in torch)

def _resnet_entries(has):
    """The ResNet family: the trunk, IBN blocks (``bn1.IN`` / ``bn1.BN``, the
    IBN-Net-a scheme of ``daliid_tpu/models/torch_port.py:625-657``), and
    every head under its flax name (BN necks; the multi-view gates, which
    are convolutions with biases)."""
    e = [("conv1", ("conv1",), "conv"), ("bn1", ("bn1",), "bn")]
    for stage in range(1, 5):
        b = 0
        while has(f"layer{stage}.{b}", (f"layer{stage}_{b}",)):
            t, name = f"layer{stage}.{b}", f"layer{stage}_{b}"
            e += [(f"{t}.{c}", (name, c), "conv") for c in ("conv1", "conv2", "conv3")]
            e += [(f"{t}.{n}", (name, n), "bn") for n in ("bn2", "bn3")]
            if has(f"{t}.bn1.IN", (name, "bn1_ibn")):
                e += [(f"{t}.bn1.IN", (name, "bn1_ibn", "instance"), "ln"),
                      (f"{t}.bn1.BN", (name, "bn1_ibn", "batch"), "bn")]
            else:
                e.append((f"{t}.bn1", (name, "bn1"), "bn"))
            if has(f"{t}.downsample", (name, "downsample_conv")):
                e += [(f"{t}.downsample.0", (name, "downsample_conv"), "conv"),
                      (f"{t}.downsample.1", (name, "downsample_bn"), "bn")]
            b += 1
    for head in ("last_bn",) + sum(_HEADS_WITHOUT_TORCH_KEYS.values(), ()):
        if has(head, (head,)):
            e.append((head, (head,), "bn" if has(f"{head}.running_mean", (head, "scale"))
                      else "conv"))
    return e


def _vit_block_entries(tk: str, path: tuple):
    """One transformer block (vit_pytorch.py:167-184 naming)."""
    return [(f"{tk}.norm1", path + ("norm1",), "ln"),
            (f"{tk}.attn.qkv", path + ("attn", "qkv"), "dense"),
            (f"{tk}.attn.proj", path + ("attn", "proj"), "dense"),
            (f"{tk}.norm2", path + ("norm2",), "ln"),
            (f"{tk}.mlp.fc1", path + ("mlp", "fc1"), "dense"),
            (f"{tk}.mlp.fc2", path + ("mlp", "fc2"), "dense")]


def _vit_trunk_entries(has, path: tuple):
    """The trunk at flax ``path`` → ``base.*``."""
    e = [("base.cls_token", path + ("cls_token",), "raw"),
         ("base.pos_embed", path + ("pos_embed",), "raw"),
         ("base.patch_embed.proj", path + ("patch_embed",), "conv")]
    if has("base.sie_embed", path + ("sie_embed",)):
        e.append(("base.sie_embed", path + ("sie_embed",), "raw"))
    i = 0
    while has(f"base.blocks.{i}", path + (f"block{i}",)):
        e += _vit_block_entries(f"base.blocks.{i}", path + (f"block{i}",))
        i += 1
    if has("base.norm", path + ("norm",)):
        e.append(("base.norm", path + ("norm",), "ln"))
    return e


def _jpm_entries(has):
    e = _vit_trunk_entries(has, ("base",))
    for branch in ("b1", "b2"):
        e += _vit_block_entries(f"{branch}.0", (f"{branch}_block",))
        e.append((f"{branch}.1", (f"{branch}_norm",), "ln"))
    for i in range(5):
        suffix = "" if i == 0 else f"_{i}"
        e.append((f"bottleneck{suffix}", (f"bottleneck{suffix}",), "bn"))
        if has(f"classifier{suffix}", (f"classifier{suffix}",)):
            e.append((f"classifier{suffix}", (f"classifier{suffix}",), "dense"))
    return e


def _conv_bn_entries(tk: str, path: tuple):
    return [(tk + ".conv", path + ("conv",), "conv"), (tk + ".bn", path + ("bn",), "bn")]


def _osnet_entries(has):
    """torchreid's ``osnet_x1_0`` naming under the ``OSNETReID`` wrapper:
    lite convolutions ``conv1`` (pointwise) / ``conv2`` (depthwise) / ``bn``,
    streams ``conv2a`` to ``conv2d``, the shared ``gate``, ``conv3`` the
    expand, ``downsample`` the projection shortcut, ``conv{2,3}.2.0`` the
    transitions."""
    e = _conv_bn_entries("conv1", ("conv1",))
    for stage in (2, 3, 4):
        for b in range(2):
            tk, path = f"conv{stage}.{b}", (f"conv{stage}_{b}",)
            e += _conv_bn_entries(tk + ".conv1", path + ("reduce",))
            for depth, stream in enumerate("abcd", start=1):
                for d in range(depth):
                    src = f"{tk}.conv2{stream}" + (f".{d}" if depth > 1 else "")
                    lite = path + (f"stream{depth}_{d}",)
                    e += [(src + ".conv1", lite + ("pw",), "conv"),
                          (src + ".conv2", lite + ("dw",), "conv"),
                          (src + ".bn", lite + ("bn",), "bn")]
            e += [(tk + ".gate.fc1", path + ("gate", "fc1"), "dense_conv1x1"),
                  (tk + ".gate.fc2", path + ("gate", "fc2"), "dense_conv1x1"),
                  (tk + ".conv3.conv", path + ("expand",), "conv"),
                  (tk + ".conv3.bn", path + ("expand_bn",), "bn")]
            if has(tk + ".downsample", path + ("shortcut",)):
                e += [(tk + ".downsample.conv", path + ("shortcut",), "conv"),
                      (tk + ".downsample.bn", path + ("shortcut_bn",), "bn")]
        if stage < 4:
            e += _conv_bn_entries(f"conv{stage}.2.0", (f"transition{stage}",))
    return e + _conv_bn_entries("conv5", ("conv5",)) + [("last_bn", ("last_bn",), "bn")]


def _densenet_entries(has):
    """torchvision ``densenet121.features`` naming under the wrapper's
    ``model_base``; the block sizes are probed."""
    e = [("model_base.conv0", ("conv0",), "conv"), ("model_base.norm0", ("norm0",), "bn")]
    bi = 1
    while has(f"model_base.denseblock{bi}", (f"block{bi}_layer0",)):
        li = 0
        while has(f"model_base.denseblock{bi}.denselayer{li + 1}", (f"block{bi}_layer{li}",)):
            tk, path = f"model_base.denseblock{bi}.denselayer{li + 1}", (f"block{bi}_layer{li}",)
            e += [(tk + ".norm1", path + ("norm1",), "bn"), (tk + ".conv1", path + ("conv1",), "conv"),
                  (tk + ".norm2", path + ("norm2",), "bn"), (tk + ".conv2", path + ("conv2",), "conv")]
            li += 1
        if has(f"model_base.transition{bi}", (f"transition{bi}",)):
            e += [(f"model_base.transition{bi}.norm", (f"transition{bi}", "norm"), "bn"),
                  (f"model_base.transition{bi}.conv", (f"transition{bi}", "conv"), "conv")]
        bi += 1
    e += [("model_base.norm5", ("norm_final",), "bn"), ("last_bn", ("last_bn",), "bn")]
    if has("classification", ("classifier",)):
        e.append(("classification", ("classifier",), "dense"))
    return e


# torchvision Inception-V3 branch attribute → flax submodule, per block family
_INCEPTION_A = [("branch1x1", "b1"), ("branch5x5_1", "b5_1"), ("branch5x5_2", "b5_2"),
                ("branch3x3dbl_1", "b3_1"), ("branch3x3dbl_2", "b3_2"),
                ("branch3x3dbl_3", "b3_3"), ("branch_pool", "bp")]
_INCEPTION_6A = [("branch3x3", "b3"), ("branch3x3dbl_1", "d3_1"), ("branch3x3dbl_2", "d3_2"),
                 ("branch3x3dbl_3", "d3_3")]
_INCEPTION_C = ([("branch1x1", "b1")] + [(f"branch7x7_{i}", f"b7_{i}") for i in (1, 2, 3)]
                + [(f"branch7x7dbl_{i}", f"d7_{i}") for i in range(1, 6)]
                + [("branch_pool", "bp")])
_INCEPTION_7A = ([("branch3x3_1", "b3_1"), ("branch3x3_2", "b3_2")]
                 + [(f"branch7x7x3_{i}", f"b7_{i}") for i in range(1, 5)])
_INCEPTION_E = [("branch1x1", "b1"), ("branch3x3_1", "b3_1"), ("branch3x3_2a", "b3_2a"),
                ("branch3x3_2b", "b3_2b"), ("branch3x3dbl_1", "d3_1"),
                ("branch3x3dbl_2", "d3_2"), ("branch3x3dbl_3a", "d3_3a"),
                ("branch3x3dbl_3b", "d3_3b"), ("branch_pool", "bp")]
_INCEPTION_BLOCKS = {
    "Mixed_5b": _INCEPTION_A, "Mixed_5c": _INCEPTION_A, "Mixed_5d": _INCEPTION_A,
    "Mixed_6a": _INCEPTION_6A,
    "Mixed_6b": _INCEPTION_C, "Mixed_6c": _INCEPTION_C, "Mixed_6d": _INCEPTION_C,
    "Mixed_6e": _INCEPTION_C,
    "Mixed_7a": _INCEPTION_7A, "Mixed_7b": _INCEPTION_E, "Mixed_7c": _INCEPTION_E,
}


def _inception_entries():
    """torchvision Inception-V3 stem and mixed-block attributes (each a
    ``BasicConv2d`` of ``conv`` + ``bn``) under the ``inceptionV3ReID``
    wrapper, plus ``last_bn``."""
    e = []
    for stem in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
                 "Conv2d_4a_3x3"):
        e += _conv_bn_entries(stem, (stem.rsplit("_", 1)[0],))
    for block, branches in _INCEPTION_BLOCKS.items():
        for bt, bf in branches:
            e += _conv_bn_entries(f"{block}.{bt}", (block, bf))
    return e + [("last_bn", ("last_bn",), "bn")]


def _efficientnet_entries():
    """torchvision EfficientNet-B0 ``features`` numbering under the
    ``efficientnetB0ReID`` wrapper: (conv, BN) pairs at ``.0`` / ``.1``, each
    MBConv's ``block`` = [expand] → depthwise → squeeze-excitation
    (``fc1`` / ``fc2``) → project."""
    e = [("features.0.0", ("stem_conv",), "conv"), ("features.0.1", ("stem_bn",), "bn")]
    for si, (expand, _ch, repeats, _stride, _kernel) in enumerate(_B0_CONFIG, start=1):
        for r in range(repeats):
            tb, path = f"features.{si}.{r}.block", (f"stage{si - 1}_{r}",)
            parts = ["dw", "se", "project"] if expand == 1 else ["expand", "dw", "se", "project"]
            for j, part in enumerate(parts):
                if part == "se":
                    e += [(f"{tb}.{j}.fc1", path + ("se", "reduce"), "dense_conv1x1"),
                          (f"{tb}.{j}.fc2", path + ("se", "expand"), "dense_conv1x1")]
                else:
                    e += [(f"{tb}.{j}.0", path + (f"{part}_conv",), "conv"),
                          (f"{tb}.{j}.1", path + (f"{part}_bn",), "bn")]
    return e + [("features.8.0", ("head_conv",), "conv"), ("features.8.1", ("head_bn",), "bn"),
                ("last_bn", ("last_bn",), "bn")]


def _entries_of(model_name: str, has):
    """The key table of ``model_name``. ``has(torch_key, flax_path)`` answers
    whether the weights at hand have the module under ``torch_key`` (the
    port's ``state_dict``) or ``flax_path`` (the JAX params): every
    structural choice (depth, SIE, IBN, shortcuts, heads, classifiers)
    names both at one call, so the two directions read one table. A model
    the JAX package lacks has no table."""
    jax_layout_refusal(model_name)
    if model_name in VIT_MODELS:
        return _vit_trunk_entries(has, ()) + [("bottleneck", ("last_bn",), "bn")]
    if model_name == "transreid_jpm":
        return _jpm_entries(has)
    if model_name == "osnet":
        return _osnet_entries(has)
    if model_name == "densenet121":
        return _densenet_entries(has)
    if model_name == "inceptionV3":
        return _inception_entries()
    if model_name == "efficientnetB0":
        return _efficientnet_entries()
    return _resnet_entries(has)


def _entries(model_name: str, params):
    """The key table of ``model_name``, its structure read from a JAX params
    tree."""
    def has(_torch_key, path):
        node = params
        for name in path:
            if not isinstance(node, Mapping) or name not in node:
                return False
            node = node[name]
        return True

    return _entries_of(model_name, has)


def _port_entries(model_name: str, keys):
    """The key table of ``model_name``, its structure read from the port's
    ``state_dict`` keys."""
    prefixes = {k.rsplit(".", i)[0] for k in keys for i in range(k.count(".") + 1)}
    return _entries_of(model_name, lambda torch_key, _path: torch_key in prefixes)


def _node(tree, path):
    for name in path:
        tree = tree[name]
    return tree


def _f32(a, transpose=None) -> torch.Tensor:
    a = np.array(a, np.float32)  # a writable copy
    if transpose is not None:
        a = np.ascontiguousarray(a.transpose(transpose))
    return torch.from_numpy(a)


def _convert(params, stats, entries) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for tk, path, kind in entries:
        node = _node(params, path)
        if kind == "raw":
            out[tk] = _f32(node)
            continue
        if kind == "conv":
            out[tk + ".weight"] = _f32(node["kernel"], (3, 2, 0, 1))
        elif kind == "dense":
            out[tk + ".weight"] = _f32(node["kernel"], (1, 0))
        elif kind == "dense_conv1x1":
            out[tk + ".weight"] = _f32(node["kernel"], (1, 0))[:, :, None, None].contiguous()
        else:  # ln, bn
            out[tk + ".weight"] = _f32(node["scale"])
        if "bias" in node:
            out[tk + ".bias"] = _f32(node["bias"])
        if kind == "bn" and stats is not None:
            s = _node(stats, path)
            out[tk + ".running_mean"] = _f32(s["mean"])
            out[tk + ".running_var"] = _f32(s["var"])
    return out


def _set(tree, path, leaf) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = leaf


def variables_to_jax(model_name: str, state_dict: Mapping[str, torch.Tensor]):
    """The inverse of :func:`variables_from_jax`: the port's ``state_dict`` of
    ``model_name`` → the JAX package's ``{'params', 'batch_stats'}`` tree of
    float32 numpy arrays, through the same key table (its structure read
    from the ``state_dict`` keys): convolution kernels OIHW → HWIO
    (depthwise ``(C, 1, H, W)`` → flax's ``(H, W, 1, C)``), Linear weights
    → Dense ``(in, out)`` kernels, the 1x1 gate convolutions → Dense, BN and
    LayerNorm ``weight`` → ``scale``, ``running_mean/var`` → ``mean/var``;
    ``num_batches_tracked`` is dropped. A key the table does not map
    raises."""
    sd = {k: v for k, v in state_dict.items() if not k.endswith("num_batches_tracked")}
    used = set()

    def take(key):
        used.add(key)
        return np.array(sd[key].detach().cpu().float().numpy(), np.float32)

    params: Dict[str, object] = {}
    stats: Dict[str, object] = {}
    for tk, path, kind in _port_entries(model_name, sd):
        if kind == "raw":
            _set(params, path, take(tk))
            continue
        w = take(tk + ".weight")
        if kind == "conv":
            _set(params, path + ("kernel",), np.ascontiguousarray(w.transpose(2, 3, 1, 0)))
        elif kind == "dense":
            _set(params, path + ("kernel",), np.ascontiguousarray(w.T))
        elif kind == "dense_conv1x1":
            _set(params, path + ("kernel",), np.ascontiguousarray(w[:, :, 0, 0].T))
        else:  # ln, bn
            _set(params, path + ("scale",), w)
        if tk + ".bias" in sd:
            _set(params, path + ("bias",), take(tk + ".bias"))
        if kind == "bn" and tk + ".running_mean" in sd:
            _set(stats, path + ("mean",), take(tk + ".running_mean"))
            _set(stats, path + ("var",), take(tk + ".running_var"))
    unmapped = sorted(set(sd) - used)
    if unmapped:
        raise ValueError(f"{len(unmapped)} keys of the {model_name} state_dict are not in its "
                         f"key table: {unmapped[:10]}")
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def params_from_jax(model_name: str, params) -> Dict[str, torch.Tensor]:
    """The JAX ``params`` tree of ``model_name`` (numpy leaves) → the port's
    parameters by ``state_dict`` key. Any tree of the params' structure
    converts the same way, so it also maps optax's Adam moments ``mu`` and
    ``nu`` onto ``torch.optim.Adam``'s ``exp_avg`` and ``exp_avg_sq``."""
    return _convert(params, None, _entries(model_name, params))


def variables_from_jax(model_name: str, variables) -> Dict[str, torch.Tensor]:
    """JAX variables of ``model_name`` (numpy leaves) → the port's
    ``state_dict``: the parameters of :func:`params_from_jax` plus the BN
    running statistics."""
    params = variables["params"]
    return _convert(params, variables.get("batch_stats", {}), _entries(model_name, params))


_QUANT_KINDS = ("conv", "dense", "dense_conv1x1")


def quant_scales_from_jax(model_name: str, scales: Mapping[str, float]) -> Dict[str, float]:
    """The JAX package's int8 calibration of ``model_name``, ``{flax module
    path: input absmax}`` (paths as ``daliid_tpu/ops/quantize.py::_module_path``
    joins them, e.g. ``layer1_0/conv1``), → the port's ``{module name:
    absmax}``, through the key tables of :func:`variables_from_jax`. The
    tables are read with a skeleton params tree built from the paths, so a
    path of a layer the tables do not map is dropped."""
    skeleton: Dict[str, object] = {}
    for path in scales:
        node = skeleton
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node["kernel"] = None
    out = {}
    for tk, path, kind in _entries(model_name, skeleton):
        key = "/".join(path)
        if kind in _QUANT_KINDS and key in scales:
            out[tk] = float(scales[key])
    return out


# ------------------------------------------------------------ reference checkpoints

def _normalize_torchvision_vit_keys(sd: Mapping[str, object]) -> Dict[str, object]:
    """Rename torchvision ``vit_b_16`` keys (the ``ViTReID`` wrapper scheme,
    ``Encoders.py:767-828``) to TransReID's. torchvision packs qkv as
    ``self_attention.in_proj_*`` in the same [q; k; v] row layout as the
    fused ``qkv``."""
    out = {}
    for k, v in sd.items():
        nk = (k.replace("class_token", "cls_token")
              .replace("encoder.pos_embedding", "pos_embed")
              .replace("conv_proj", "patch_embed.proj")
              .replace("encoder.ln", "norm"))
        if ".encoder.layers.encoder_layer_" in "." + nk:
            head, rest = nk.split("encoder.layers.encoder_layer_", 1)
            idx, sub = rest.split(".", 1)
            sub = (sub.replace("ln_1", "norm1").replace("ln_2", "norm2")
                   .replace("self_attention.out_proj", "attn.proj")
                   .replace("self_attention.in_proj_weight", "attn.qkv.weight")
                   .replace("self_attention.in_proj_bias", "attn.qkv.bias")
                   .replace("mlp.0", "mlp.fc1").replace("mlp.3", "mlp.fc2")
                   .replace("mlp.linear_1", "mlp.fc1").replace("mlp.linear_2", "mlp.fc2"))
            nk = f"{head}blocks.{idx}.{sub}"
        out[nk] = v
    return out


def _resized_pos(sd: Dict[str, torch.Tensor], module) -> None:
    """Resize ``base.pos_embed`` in place to the module's grid; a
    checkpoint's grid is taken as square, as the reference loader does."""
    pos = sd.get("base.pos_embed")
    if module is None or pos is None:
        return
    grid = module.base.grid_hw
    if pos.shape[1] == grid[0] * grid[1] + 1:
        return
    n_old = pos.shape[1] - 1
    side = int(round(n_old ** 0.5))
    if side * side != n_old:
        raise ValueError(f"cannot infer the checkpoint's grid for {n_old} tokens")
    sd["base.pos_embed"] = torch.from_numpy(
        resize_pos_embed(pos.numpy(), tuple(grid), (side, side)))


_VIT_TRUNK = ("cls_token", "pos_embed", "patch_embed.", "sie_embed", "blocks.", "norm.")
_VIT_UNUSED = ("fc.", "heads.head.", "classifier", "base.fc.")
_NECKS = ("bottleneck.", "last_bn.", "base.bottleneck.", "base.last_bn.")


def _vit_state(sd, module) -> Dict[str, torch.Tensor]:
    """The bare ``vit_pytorch`` backbone, ``build_transformer`` (``base.*``
    and its ``bottleneck``) or torchvision's ``vit_b_16`` under the
    ``ViTReID`` wrapper (``last_bn``) → the port's ViTReID keys; the
    ImageNet and classifier heads the wrappers keep are dropped."""
    sd = _normalize_torchvision_vit_keys(sd)
    if not any(k.startswith("base.") for k in sd):
        sd = {("base." + k if k.startswith(_VIT_TRUNK) else k): v for k, v in sd.items()}
    out = {}
    for k, v in sd.items():
        if k.startswith(_VIT_UNUSED):
            continue
        if k.startswith(_NECKS):
            k = "bottleneck." + k.rsplit(".", 1)[1]
        out[k] = v
    if "bottleneck.weight" not in out:  # a bare backbone: identity neck
        dim = out["base.cls_token"].shape[-1]
        out.update({"bottleneck.weight": torch.ones(dim), "bottleneck.bias": torch.zeros(dim),
                    "bottleneck.running_mean": torch.zeros(dim),
                    "bottleneck.running_var": torch.ones(dim)})
    _resized_pos(out, module)
    return out


def _jpm_state(sd, module) -> Dict[str, torch.Tensor]:
    """``build_transformer_local`` (``make_models.py:221-389``) → the port's
    keys: ``base.blocks.{depth-1}`` and ``base.norm``, only the deepcopy
    sources of b1 and b2 there, are dropped."""
    depth = module.base.depth if module is not None else 12
    unused = ("base.fc.", f"base.blocks.{depth - 1}.", "base.norm.")
    out = {k: v for k, v in sd.items() if not k.startswith(unused)}
    if module is not None and not hasattr(module, "classifier"):
        out = {k: v for k, v in out.items() if not k.startswith("classifier")}
    elif "classifier.weight" in out and "classifier_1.weight" not in out:
        # a margin-head checkpoint has the one margin classifier: fill the
        # local heads, which its train path never reads and eval discards,
        # with the reference's classifier init (make_models.py:39-44)
        rng = np.random.default_rng(12)
        shape = tuple(out["classifier.weight"].shape)
        for i in range(1, 5):
            out[f"classifier_{i}.weight"] = torch.from_numpy(
                rng.normal(0.0, 0.001, size=shape).astype(np.float32))
    _resized_pos(out, module)
    return out


# the heads that the reference ResNet-50 key scheme, to which the JAX
# converter maps these models (``variables_from_torch``, :815-817), has no
# entries for
_HEADS_WITHOUT_TORCH_KEYS = {
    "dualresnet50": ("id_bn", "bias_bn"),
    "multipart_resnet50": ("upper_bn", "middle_bn", "lower_bn"),
    "multiview_resnet50": ("spatial_gate", "channel_squeeze", "channel_expand", "spatial_bn",
                           "channel_bn"),
}
# the IBN-Net ImageNet head that the reference wrappers keep and never use
_IBN_UNUSED = ("fc.", "model_base.fc.")
# the upstream heads that the CNN zoo's wrappers keep and never use
# (torchvision Inception-V3's auxiliary tower among them)
_ZOO_UNUSED = {
    "osnet": ("fc.", "classifier.", "model_base.fc.", "model_base.classifier."),
    "densenet121": ("model_base.classifier.",),
    "inceptionV3": ("AuxLogits.", "fc.", "model_base.AuxLogits.", "model_base.fc."),
    "efficientnetB0": ("classifier.", "model_base.classifier."),
}


def _without_unused_classifier(sd: Dict[str, torch.Tensor], module) -> Dict[str, torch.Tensor]:
    """Drop a DenseNet ``classification`` head that ``module`` (built with
    ``num_classes=0``) does not have: evaluation reads the embedding only."""
    if module is None or hasattr(module, "classification"):
        return sd
    return {k: v for k, v in sd.items() if not k.startswith("classification.")}


def state_from_torch(model_name: str, state_dict: Mapping[str, object],
                     module=None) -> Dict[str, torch.Tensor]:
    """A reference checkpoint of ``model_name`` → the port's ``state_dict``.
    ``module`` (the port's model) gives the depth and the patch grid that
    the position embedding is resized to.

    A torch checkpoint of a multi-head ResNet without its heads is refused
    with an error that names them: the JAX package reads such a file as a
    plain ResNet-50 and its forward then fails on the missing heads."""
    sd = {k: torch.as_tensor(v) for k, v in strip_module_prefix(dict(state_dict)).items()}
    if model_name in VIT_MODELS:
        return _vit_state(sd, module)
    if model_name == "transreid_jpm":
        return _jpm_state(sd, module)
    if model_name in ("resnet50IBN", "resnet101IBN"):
        return {k: v for k, v in sd.items() if not k.startswith(_IBN_UNUSED)}
    if model_name in _ZOO_UNUSED:
        return _without_unused_classifier(
            {k: v for k, v in sd.items() if not k.startswith(_ZOO_UNUSED[model_name])
             and not k.endswith("num_batches_tracked")}, module)
    missing = [h for h in _HEADS_WITHOUT_TORCH_KEYS.get(model_name, ())
               if not any(k.startswith(h + ".") for k in sd)]
    if missing:
        raise ValueError(
            f"this torch checkpoint of {model_name} has no weights for its heads "
            f"{', '.join(missing)}: the reference ResNet-50 key scheme has no entries for "
            f"them; load the JAX package's save_variables .npz of the model instead")
    return sd


def _denormalize_to_torchvision_vit_keys(sd: Mapping[str, object]) -> Dict[str, object]:
    """The inverse of :func:`_normalize_torchvision_vit_keys` on a bare
    TransReID trunk (no ``base.``): → torchvision ``vit_b_16`` naming, the
    ``ViTReID`` wrapper scheme (``Encoders.py:767-828``)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("blocks."):
            _, idx, rest = k.split(".", 2)
            rest = (rest.replace("norm1", "ln_1").replace("norm2", "ln_2")
                    .replace("attn.proj", "self_attention.out_proj")
                    .replace("attn.qkv.weight", "self_attention.in_proj_weight")
                    .replace("attn.qkv.bias", "self_attention.in_proj_bias")
                    .replace("mlp.fc1", "mlp.0").replace("mlp.fc2", "mlp.3"))
            nk = f"encoder.layers.encoder_layer_{idx}.{rest}"
        else:
            nk = (k.replace("cls_token", "class_token")
                  .replace("pos_embed", "encoder.pos_embedding")
                  .replace("patch_embed.proj", "conv_proj")
                  .replace("norm.weight", "encoder.ln.weight")
                  .replace("norm.bias", "encoder.ln.bias"))
        out[nk] = v
    return out


def multihead_torch_refusal(model_name: str) -> str:
    """Why a multi-head ResNet has no reference torch checkpoint."""
    return (f"{model_name} cannot be exported to a torch pickle: the reference ResNet-50 key "
            f"scheme has no entries for its heads "
            f"{', '.join(_HEADS_WITHOUT_TORCH_KEYS[model_name])}, which the file would lose; "
            f"keep the model as an .npz (which the port and the JAX package both read)")


def state_to_torch(model_name: str, state_dict: Mapping[str, torch.Tensor],
                   module=None) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of ``model_name`` → the reference scheme that
    the JAX package's ``variables_to_torch`` writes
    (``daliid_tpu/models/torch_port.py:848-899``), as float32 CPU tensors
    without ``num_batches_tracked``. The port's keys are that scheme but
    for ``vit``, whose reference wrapper is torchvision's ``vit_b_16``
    (``class_token``, ``encoder.layers.encoder_layer_{i}.*``, the neck
    ``last_bn`` and torchvision's unused ImageNet head ``heads.head`` as
    zeros of (1000, D) and (1000,), so that a strict load succeeds), and a
    margin-head ``transreid_jpm`` (``module.id_loss_type``), whose
    reference model has no ``classifier_1..4``.

    A multi-head ResNet is refused with an error that names its heads: the
    reference ResNet-50 scheme has no entries for them (the JAX package's
    export drops them from a multi-part or multi-view file and fails on
    the dual one). ``tiny_vit_smoke`` has no reference scheme, and a model
    that exists only in the port is refused by name."""
    jax_layout_refusal(model_name)
    if model_name in _HEADS_WITHOUT_TORCH_KEYS:
        raise ValueError(multihead_torch_refusal(model_name))
    if model_name == "tiny_vit_smoke":
        raise KeyError(f"no reference torch scheme for model {model_name!r}")
    out = {k: v.detach().cpu().float() for k, v in strip_module_prefix(dict(state_dict)).items()
           if not k.endswith("num_batches_tracked")}
    if model_name == "vit":
        neck = {"last_bn." + k.split(".", 1)[1]: v for k, v in out.items()
                if k.startswith("bottleneck.")}
        out = _denormalize_to_torchvision_vit_keys(
            {k[len("base."):]: v for k, v in out.items() if k.startswith("base.")})
        out.update(neck)
        dim = out["class_token"].shape[-1]
        out["heads.head.weight"] = torch.zeros(1000, dim)
        out["heads.head.bias"] = torch.zeros(1000)
    elif (model_name == "transreid_jpm"
          and getattr(module, "id_loss_type", "softmax") != "softmax"):
        out = {k: v for k, v in out.items()
               if not k.startswith(tuple(f"classifier_{i}." for i in range(1, 5)))}
    return out


def load_state(model_name: str, path: str, module=None) -> Dict[str, torch.Tensor]:
    """Weights file of ``model_name`` → ``state_dict``: a JAX ``.npz`` or a
    torch pickle (a reference checkpoint, or a ``model_*.pt`` the port's
    trainer wrote)."""
    if path.endswith(".npz"):
        jax_layout_refusal(model_name)
        return _without_unused_classifier(variables_from_jax(model_name, read_jax_npz(path)),
                                          module)
    return state_from_torch(model_name, load_torch_checkpoint(path), module)
