"""Checkpoint conversion CLI: reference torch format ↔ the JAX package's npz.

Port of ``daliid_tpu/cli/export.py``, with its flags plus ``--device``. The
port trains into torch ``state_dict`` files (``model_*.pt``); the JAX
package's native format is a flat ``.npz`` of flax variables
(``train/checkpoint.py::save_variables``). This command carries weights
both ways, so a model trained with the port reaches the JAX package and a
JAX-trained model reaches the reference's wrappers:

    # reference .h5/.pth, or a port-trained .pt → JAX npz
    python -m daliid_tpu_torch export --model_name resnet50 \\
        --input model_online_resnet50_v0.pt --output weights.npz

    # JAX npz → reference-loadable state_dict pickle
    python -m daliid_tpu_torch export --model_name resnet50 \\
        --input weights.npz --output weights.pth

The direction comes from the file extensions (the torch side takes
.h5/.pth/.pt/.bin, all torch pickles). torch → npz reads the checkpoint
with ``state_from_torch`` against the model built at ``--img_height`` x
``--img_width`` (so a ViT's position embedding is resized to its grid) and
writes ``variables_to_jax`` of it; npz → torch reads the file against the
variables of a fresh model (every leaf required at its shape) and writes
``state_to_torch``'s reference scheme. A multi-head ResNet
(``dualresnet50``, ``multipart_resnet50``, ``multiview_resnet50``) is
refused to a torch pickle, whose reference scheme has no keys for its
heads: keep it as an ``.npz``. A model that exists only in the port
(``swin_base``) has no JAX layout and is refused either way.
"""

from __future__ import annotations

import argparse

import torch

from daliid_tpu_torch.device import add_device_flag, resolve_device

TORCH_EXTS = (".h5", ".pth", ".pt", ".bin")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DaliID checkpoint conversion (PyTorch/CUDA)")
    p.add_argument("--model_name", type=str, required=True)
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--img_height", type=int, default=256)
    p.add_argument("--img_width", type=int, default=128)
    p.add_argument("--num_classes", type=int, default=0)
    p.add_argument("--sie_cameras", type=int, default=0)
    add_device_flag(p)
    return p


def main(args):
    from daliid_tpu_torch.models import get_model
    from daliid_tpu_torch.models.factory import jax_layout_refusal
    from daliid_tpu_torch.models.torch_port import (
        _HEADS_WITHOUT_TORCH_KEYS,
        load_torch_checkpoint,
        multihead_torch_refusal,
        state_from_torch,
        state_to_torch,
        variables_from_jax,
        variables_to_jax,
    )
    from daliid_tpu_torch.train.checkpoint import load_variables, save_variables

    to_torch = args.output.lower().endswith(TORCH_EXTS)
    from_torch = args.input.lower().endswith(TORCH_EXTS)
    npz_in = args.input.lower().endswith(".npz")
    npz_out = args.output.lower().endswith(".npz")
    if not ((from_torch and npz_out) or (npz_in and to_torch)):
        raise SystemExit(
            f"exactly one side must be a torch pickle ({'/'.join(TORCH_EXTS)}) "
            f"and the other an .npz: got {args.input} -> {args.output}"
        )
    try:
        jax_layout_refusal(args.model_name)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if to_torch and args.model_name in _HEADS_WITHOUT_TORCH_KEYS:
        raise SystemExit(multihead_torch_refusal(args.model_name))
    device = resolve_device(args.device)

    model_kw = {}
    if args.num_classes:
        model_kw["num_classes"] = args.num_classes
    if args.sie_cameras:
        model_kw["sie_cameras"] = args.sie_cameras
    module = get_model(args.model_name, torch.Generator().manual_seed(0),
                       img_size=(args.img_height, args.img_width), dtype=torch.float32,
                       device=device, **model_kw).module

    if from_torch:
        state = state_from_torch(args.model_name, load_torch_checkpoint(args.input), module)
        save_variables(args.output, variables_to_jax(args.model_name, state))
    else:
        template = variables_to_jax(args.model_name, module.state_dict())
        state = variables_from_jax(args.model_name, load_variables(args.input, template))
        torch.save(state_to_torch(args.model_name, state, module), args.output)
    print(f"converted {args.input} -> {args.output} ({args.model_name})")
    return args.output


if __name__ == "__main__":
    main(build_argparser().parse_args())
