"""A configuration's model on both sides, found from its file.

``benchmark/configs/<config>.json`` names the model's plain reference by
path (``reference``): a module with ``spec(cfg)``, ``forward(cfg, P, x,
train, prec, generator)``, ``flops(cfg, train)`` and ``attention(cfg)``,
each worked out from the widths the file states. The file's ``program``
says how the program builds the model: a name of the program's model
registry (``factory``) or a class (``class``, ``module:Name``), with fixed
``kwargs`` and the configuration keys listed in ``widths`` passed under
their own names. Both sides are loaded from the same seeded weights, made
from the reference's ``spec``; the program's module has to take them whole
(every name and shape) and give the embedding width the file states, so a
configuration at widths the program does not build fails at once.
"""

from __future__ import annotations

import importlib
import importlib.util

import torch

from benchmark.harness import core, weights as wmod

_LOADED: dict = {}


def reference(config: dict):
    """The configuration's reference module, loaded from its path."""
    path = core.ROOT / config["reference"]
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no reference {config['reference']}")
        spec = importlib.util.spec_from_file_location(f"benchmark_model_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def make_weights(config: dict, seed: int, device) -> dict:
    return wmod.make(reference(config).spec(config), seed, device)


def build_program(config: dict, state: dict, device):
    """The program's module for ``config`` on ``device``, loaded with
    ``state``, as the program's ``ModelBundle``."""
    from daliid_tpu_torch.models.factory import MODEL_REGISTRY, ModelBundle

    prog = config["program"]
    kwargs = dict(prog.get("kwargs", {}))
    kwargs.update({k: config[k] for k in prog.get("widths", [])})
    dtype, img_size = getattr(torch, config["compute_dtype"]), tuple(config["img_size"])
    with torch.device(device):
        if "class" in prog:
            mod, name = prog["class"].split(":")
            module = getattr(importlib.import_module(mod), name)(
                dtype=dtype, img_size=img_size, **kwargs)
            dim = module.feature_dim
        else:
            module, dim = MODEL_REGISTRY[prog["factory"]](dtype=dtype, img_size=img_size,
                                                          **kwargs)
    module.load_state_dict(state, strict=True)
    if dim != config["feature_dim"]:
        raise ValueError(f"{config['name']}: the program's embedding is {dim} wide, "
                         f"the configuration states {config['feature_dim']}")
    return ModelBundle(module=module.to(device), feature_dim=dim, name=config["name"])
