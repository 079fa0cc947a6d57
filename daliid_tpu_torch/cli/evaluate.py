"""Single-model evaluation CLI on the GPU — port of ``daliid_tpu/cli/evaluate.py``.

Loads a backbone and weights, extracts query and gallery embeddings, builds
the cosine distance matrix on the device and ranks CMC/mAP through kernel
K2. Flags are the JAX CLI's (``:31-110``) plus ``--device``; the flags of
features not ported yet (turbulence galleries, BRIAR manifests, multi-head
ensembles, re-ranking, SIE/GELU options of the ViT family, sharded and
multi-host evaluation, int8 extraction) exit with an error that names them.

Example::

    python -m daliid_tpu_torch.cli.evaluate --targets Synthetic --data_root /tmp/dd \\
        --model_name resnet50 --model_path weights.npz
"""

from __future__ import annotations

import argparse

import torch

from daliid_tpu_torch.cli.common import MULTIHOST_FLAGS, add_multihost_flags, reject_unported
from daliid_tpu_torch.data.registry import load_dataset
from daliid_tpu_torch.device import add_device_flag, parse_dtype, resolve_device
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.eval.validate import get_validator
from daliid_tpu_torch.models import get_model
from daliid_tpu_torch.models.torch_port import load_state

_UNPORTED = {
    "turbulence_dir_path": None, "turbulence_strength": None,
    "train_file_path": None, "queries_file_path": None, "gallery_file_path": None,
    "multiple_output": False, "mrfuse": False, "head_weighting": "mean",
    "rerank": False, "sie_cameras": 0, "sie_coef": 1.5, "gelu_approx": False,
    "quantize": None, "calib_batches": 1, **MULTIHOST_FLAGS,
}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DaliID single-model evaluation (PyTorch/CUDA)")
    p.add_argument("--targets", type=str, nargs="+", required=True)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--model_name", type=str, default="resnet50")
    p.add_argument("--model_path", type=str, default=None,
                   help="JAX save_variables .npz or reference torch state_dict")
    p.add_argument("--img_height", type=int, default=256)
    p.add_argument("--img_width", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--turbulence_dir_path", type=str, default=None, help="not yet ported")
    p.add_argument("--turbulence_strength", type=int, default=None, help="not yet ported")
    p.add_argument("--train_file_path", type=str, default=None, help="not yet ported")
    p.add_argument("--queries_file_path", type=str, default=None, help="not yet ported")
    p.add_argument("--gallery_file_path", type=str, default=None, help="not yet ported")
    p.add_argument("--multiple_output", action="store_true", help="not yet ported")
    p.add_argument("--mrfuse", action="store_true", help="not yet ported")
    p.add_argument("--head_weighting", type=str, default="mean",
                   choices=["mean", "magnitude"], help="not yet ported")
    p.add_argument("--rerank", action="store_true", help="not yet ported")
    p.add_argument("--sie_cameras", type=int, default=0, help="not yet ported")
    p.add_argument("--sharded_eval", action=argparse.BooleanOptionalAction, default=None,
                   help="only --no-sharded_eval (the replicated path) is ported")
    p.add_argument("--sie_coef", type=float, default=1.5, help="not yet ported")
    p.add_argument("--gelu_approx", action="store_true", help="not yet ported")
    p.add_argument("--quantize", type=str, default=None, choices=["int8"], help="not yet ported")
    p.add_argument("--calib_batches", type=int, default=1, help="not yet ported")
    add_multihost_flags(p)
    add_device_flag(p)
    return p


def load_bundle(model_name: str, model_path: str | None, dtype: torch.dtype, device):
    """Build the model on ``device`` (init seeded with 12, the JAX CLI's key)
    and load ``model_path``: a JAX ``save_variables`` ``.npz`` or a reference
    torch ``state_dict`` pickle. Port of
    ``daliid_tpu/cli/evaluate.py::load_bundle`` (``:113``)."""
    bundle = get_model(model_name, torch.Generator().manual_seed(12), dtype=dtype,
                       device=device)
    if model_path:
        bundle.module.load_state_dict(load_state(model_path), strict=True)
        print(f"Loaded weights from {model_path}")
    return bundle


def main(args):
    reject_unported(args, _UNPORTED)
    if args.sharded_eval:
        raise SystemExit("--sharded_eval is not yet ported to daliid_tpu_torch")
    if "BRIAR" in args.targets:
        raise SystemExit("the BRIAR target (manifest evaluation) is not yet ported")
    device = resolve_device(args.device)
    img_size = (args.img_height, args.img_width)
    bundle = load_bundle(args.model_name, args.model_path, parse_dtype(args.compute_dtype),
                         device)
    extractor = FeatureExtractor(bundle, img_size=img_size, batch_size=args.batch_size,
                                 device=device)
    results = {}
    for target in args.targets:
        splits = load_dataset(target, root=args.data_root)
        queries, gallery = splits["query"], splits["gallery"]
        validator = get_validator(target, img_size=img_size, batch_size=args.batch_size,
                                  device=device)
        q_fvs = extractor.extract(queries, verbose=True)
        g_fvs = extractor.extract(gallery, verbose=True)
        cmc, mAP = validator.rank(validator.distance_matrix(q_fvs, g_fvs), queries, gallery)
        print(f"[{target}] mAP: {mAP:.2%}")
        for r in (1, 5, 10, 20):
            if r <= len(cmc):
                print(f"[{target}] Rank-{r:<3}: {cmc[r - 1]:.2%}")
        results[target] = (cmc, mAP)
    return results


if __name__ == "__main__":
    main(build_argparser().parse_args())
