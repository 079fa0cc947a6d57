"""Weight carry into the port: JAX variables, JAX ``.npz`` files and the
reference's torch checkpoints → the port's ``state_dict``.

The port's ``state_dict`` keys are the reference's torch keys, the scheme
``daliid_tpu/models/torch_port.py::resnet50_reid_to_torch_keys``
(``:901-932``) emits:

- :func:`variables_from_jax` turns the JAX package's ``{'params',
  'batch_stats'}`` tree of numpy arrays into that ``state_dict``:
  convolution kernels HWIO → OIHW, BN ``scale/bias/mean/var`` →
  ``weight/bias/running_mean/running_var``;
- :func:`params_from_jax` does the same for a tree of the params' structure
  alone: the params, or optax's Adam moments ``mu`` and ``nu``;
- :func:`read_jax_npz` reads the ``.npz`` that the JAX package's
  ``train/checkpoint.py::save_variables`` writes, whose keys are
  ``jax.tree_util.keystr`` paths such as
  ``['params']['layer1_0']['conv1']['kernel']``, parsed here as strings;
- :func:`load_torch_checkpoint` reads a reference ``state_dict`` pickle
  (``daliid_tpu/models/torch_port.py:39-44``), which already has the
  port's layout once DataParallel's ``module.`` prefix is dropped, and the
  ``model_{online,momentum}_<name>_<version>.pt`` files the port's trainer
  writes.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_KEYSTR_PART = re.compile(r"\['([^']*)'\]")


def strip_module_prefix(state_dict: Mapping[str, object]) -> Dict[str, object]:
    """Drop DataParallel's ``module.`` key prefix."""
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in state_dict.items()}


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference torch ``state_dict`` pickle → the port's ``state_dict``
    (``num_batches_tracked`` counters, which eval does not read, dropped)."""
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


def _walk_resnet(params, put_conv, put_bn) -> None:
    """Visit the JAX ``ResNet50ReID`` tree in the reference's torch names:
    ``put_conv(torch_prefix, jax_node)`` per convolution and
    ``put_bn(torch_prefix, jax_path)`` per BN (``jax_path`` the tuple of
    names to that BN's node)."""
    put_conv("conv1", params["conv1"])
    put_bn("bn1", ("bn1",))
    put_bn("last_bn", ("last_bn",))
    for name, p in params.items():
        if not name.startswith("layer"):
            continue
        stage, b = name[len("layer"):].split("_")
        t = f"layer{stage}.{b}"
        for ci in ("conv1", "conv2", "conv3"):
            put_conv(f"{t}.{ci}", p[ci])
        for bi in ("bn1", "bn2", "bn3"):
            put_bn(f"{t}.{bi}", (name, bi))
        if "downsample_conv" in p:
            put_conv(f"{t}.downsample.0", p["downsample_conv"])
            put_bn(f"{t}.downsample.1", (name, "downsample_bn"))


def _node(tree, path):
    for name in path:
        tree = tree[name]
    return tree


def _conv_oihw(kernel) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)))


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """A JAX ``ResNet50ReID`` ``params`` tree (numpy leaves) → the port's
    parameters by ``state_dict`` key: kernels HWIO → OIHW, BN ``scale`` /
    ``bias`` → ``weight`` / ``bias``. Any tree of the params' structure
    converts the same way, so it also maps optax's Adam moments ``mu`` and
    ``nu`` onto ``torch.optim.Adam``'s ``exp_avg`` and ``exp_avg_sq``."""
    out: Dict[str, torch.Tensor] = {}

    def put_conv(tk, leaf):
        out[tk + ".weight"] = _conv_oihw(leaf["kernel"])

    def put_bn(tk, path):
        p = _node(params, path)
        out[tk + ".weight"] = torch.from_numpy(np.array(p["scale"], np.float32))
        out[tk + ".bias"] = torch.from_numpy(np.array(p["bias"], np.float32))

    _walk_resnet(params, put_conv, put_bn)
    return out


def variables_from_jax(variables) -> Dict[str, torch.Tensor]:
    """JAX ``ResNet50ReID`` variables (numpy leaves) → the port's
    ``state_dict`` in the reference's torch key scheme: the parameters of
    :func:`params_from_jax` plus BN ``mean/var`` → ``running_mean/var``."""
    out = params_from_jax(variables["params"])
    stats = variables["batch_stats"]

    def put_bn(tk, path):
        s = _node(stats, path)
        out[tk + ".running_mean"] = torch.from_numpy(np.array(s["mean"], np.float32))
        out[tk + ".running_var"] = torch.from_numpy(np.array(s["var"], np.float32))

    _walk_resnet(variables["params"], lambda tk, leaf: None, put_bn)
    return out


def load_state(path: str) -> Dict[str, torch.Tensor]:
    """Weights file → ``state_dict``: a JAX ``.npz`` or a torch pickle."""
    if path.endswith(".npz"):
        return variables_from_jax(read_jax_npz(path))
    return load_torch_checkpoint(path)
