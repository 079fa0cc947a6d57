"""Weight carry into the port: JAX variables, JAX ``.npz`` files and the
reference's torch checkpoints → the port's ``state_dict``.

The port's ``state_dict`` keys are the reference's torch keys, the schemes
that ``daliid_tpu/models/torch_port.py`` emits: ``resnet50_reid_to_torch_keys``
(``:901-932``) and ``resnet_ibn_reid_to_torch_keys`` (``:670-680``) for the
ResNets (a multi-head model's heads under their flax names),
``vit_reid_to_torch_keys(wrapper='base')`` (``:413``) for the ViTReID family (``base.*`` + the ``bottleneck`` neck) and
``transreid_jpm_to_torch_keys`` (``:496``) for TransReID-JPM. Every entry
point dispatches on the model name, as ``variables_from_torch`` does
(``:810-846``):

- :func:`variables_from_jax` turns the JAX package's ``{'params',
  'batch_stats'}`` tree of numpy arrays into that ``state_dict``:
  convolution kernels HWIO → OIHW, Dense kernels (in, out) → Linear
  weights (out, in), LayerNorm and BN ``scale`` → ``weight``, BN
  ``mean/var`` → ``running_mean/var``, the ViT's ``cls_token``,
  ``pos_embed`` and ``sie_embed`` as they are;
- :func:`params_from_jax` does the same for a tree of the params' structure
  alone: the params, or optax's Adam moments ``mu`` and ``nu``;
- :func:`read_jax_npz` reads the ``.npz`` that the JAX package's
  ``train/checkpoint.py::save_variables`` writes, whose keys are
  ``jax.tree_util.keystr`` paths such as
  ``['params']['layer1_0']['conv1']['kernel']``, parsed here as strings;
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
  grid (``:478-492``).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from daliid_tpu_torch.models.factory import VIT_MODELS
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
# (LayerNorm), bn and raw (the array under its own key)

def _resnet_entries(params):
    """The ResNet family: the trunk, IBN blocks (``bn1.IN`` / ``bn1.BN``, the
    IBN-Net-a scheme of ``daliid_tpu/models/torch_port.py:625-657``), and
    every head under its flax name (BN necks; the multi-view gates, which
    are convolutions with biases)."""
    e = [("conv1", ("conv1",), "conv"), ("bn1", ("bn1",), "bn")]
    for name, p in params.items():
        if not name.startswith("layer"):
            if name not in ("conv1", "bn1"):
                e.append((name, (name,), "conv" if "kernel" in p else "bn"))
            continue
        stage, b = name[len("layer"):].split("_")
        t = f"layer{stage}.{b}"
        e += [(f"{t}.{c}", (name, c), "conv") for c in ("conv1", "conv2", "conv3")]
        e += [(f"{t}.{n}", (name, n), "bn") for n in ("bn2", "bn3")]
        if "bn1_ibn" in p:
            e += [(f"{t}.bn1.IN", (name, "bn1_ibn", "instance"), "ln"),
                  (f"{t}.bn1.BN", (name, "bn1_ibn", "batch"), "bn")]
        else:
            e.append((f"{t}.bn1", (name, "bn1"), "bn"))
        if "downsample_conv" in p:
            e += [(f"{t}.downsample.0", (name, "downsample_conv"), "conv"),
                  (f"{t}.downsample.1", (name, "downsample_bn"), "bn")]
    return e


def _vit_block_entries(tk: str, path: tuple):
    """One transformer block (vit_pytorch.py:167-184 naming)."""
    return [(f"{tk}.norm1", path + ("norm1",), "ln"),
            (f"{tk}.attn.qkv", path + ("attn", "qkv"), "dense"),
            (f"{tk}.attn.proj", path + ("attn", "proj"), "dense"),
            (f"{tk}.norm2", path + ("norm2",), "ln"),
            (f"{tk}.mlp.fc1", path + ("mlp", "fc1"), "dense"),
            (f"{tk}.mlp.fc2", path + ("mlp", "fc2"), "dense")]


def _vit_trunk_entries(trunk, path: tuple):
    """The trunk at flax ``path`` (its node ``trunk``) → ``base.*``."""
    e = [("base.cls_token", path + ("cls_token",), "raw"),
         ("base.pos_embed", path + ("pos_embed",), "raw"),
         ("base.patch_embed.proj", path + ("patch_embed",), "conv")]
    if "sie_embed" in trunk:
        e.append(("base.sie_embed", path + ("sie_embed",), "raw"))
    depth = sum(1 for k in trunk if re.fullmatch(r"block\d+", k))
    for i in range(depth):
        e += _vit_block_entries(f"base.blocks.{i}", path + (f"block{i}",))
    if "norm" in trunk:
        e.append(("base.norm", path + ("norm",), "ln"))
    return e


def _jpm_entries(params):
    e = _vit_trunk_entries(params["base"], ("base",))
    for branch in ("b1", "b2"):
        e += _vit_block_entries(f"{branch}.0", (f"{branch}_block",))
        e.append((f"{branch}.1", (f"{branch}_norm",), "ln"))
    for i in range(5):
        suffix = "" if i == 0 else f"_{i}"
        e.append((f"bottleneck{suffix}", (f"bottleneck{suffix}",), "bn"))
        if f"classifier{suffix}" in params:
            e.append((f"classifier{suffix}", (f"classifier{suffix}",), "dense"))
    return e


def _entries(model_name: str, params):
    if model_name in VIT_MODELS:
        return _vit_trunk_entries(params, ()) + [("bottleneck", ("last_bn",), "bn")]
    if model_name == "transreid_jpm":
        return _jpm_entries(params)
    return _resnet_entries(params)


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
        else:  # ln, bn
            out[tk + ".weight"] = _f32(node["scale"])
        if "bias" in node:
            out[tk + ".bias"] = _f32(node["bias"])
        if kind == "bn" and stats is not None:
            s = _node(stats, path)
            out[tk + ".running_mean"] = _f32(s["mean"])
            out[tk + ".running_var"] = _f32(s["var"])
    return out


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
    missing = [h for h in _HEADS_WITHOUT_TORCH_KEYS.get(model_name, ())
               if not any(k.startswith(h + ".") for k in sd)]
    if missing:
        raise ValueError(
            f"this torch checkpoint of {model_name} has no weights for its heads "
            f"{', '.join(missing)}: the reference ResNet-50 key scheme has no entries for "
            f"them; load the JAX package's save_variables .npz of the model instead")
    return sd


def load_state(model_name: str, path: str, module=None) -> Dict[str, torch.Tensor]:
    """Weights file of ``model_name`` → ``state_dict``: a JAX ``.npz`` or a
    torch pickle (a reference checkpoint, or a ``model_*.pt`` the port's
    trainer wrote)."""
    if path.endswith(".npz"):
        return variables_from_jax(model_name, read_jax_npz(path))
    return state_from_torch(model_name, load_torch_checkpoint(path), module)
