"""Single-model evaluation CLI on the GPU — port of ``daliid_tpu/cli/evaluate.py``.

Loads a backbone and weights, extracts query and gallery embeddings, builds
the cosine distance matrix on the device and ranks CMC/mAP through kernel
K2. Flags are the JAX CLI's (``:31-110``) plus ``--device``, with its
checks (``:136-150``, ``:170``, ``:203-216``): ``--sie_cameras`` and
``--sie_coef`` for the SIE models, ``--gelu_approx`` for the ViT family,
``--head_weighting`` only with ``--multiple_output``. A multi-head model
with ``--multiple_output`` reports each head, then the heads' ensemble
(``--head_weighting``), then with ``--mrfuse`` the meta-recognition fusion
of the first three heads' similarities (``:278-317``, the replicated path).
``--rerank`` applies k-reciprocal re-ranking before the metrics
(``:225``, ``:323``), single-output evaluation only, as in JAX.
``--quantize int8`` extracts in int8 (``--calib_batches`` of calibration).
The flags of features not ported yet (turbulence galleries, BRIAR
manifests, sharded and multi-host evaluation) exit with an error that
names them.

Example::

    python -m daliid_tpu_torch.cli.evaluate --targets Synthetic --data_root /tmp/dd \\
        --model_name resnet50 --model_path weights.npz
"""

from __future__ import annotations

import argparse

import torch

from daliid_tpu_torch.cli.common import (
    MULTIHOST_FLAGS,
    add_multihost_flags,
    check_camera_ids,
    reject_briar,
    reject_unported,
)
from daliid_tpu_torch.data.registry import load_dataset
from daliid_tpu_torch.device import add_device_flag, parse_dtype, resolve_device
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.eval.meta_recognition import mrfuse
from daliid_tpu_torch.eval.validate import get_validator
from daliid_tpu_torch.models.factory import (
    GELU_APPROX_MODELS,
    MULTIHEAD_MODELS,
    SIE_MODELS,
    get_model,
)
from daliid_tpu_torch.models.torch_port import load_state

_UNPORTED = {
    "turbulence_dir_path": None, "turbulence_strength": None,
    "train_file_path": None, "queries_file_path": None, "gallery_file_path": None,
    **MULTIHOST_FLAGS,
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
    p.add_argument("--multiple_output", action="store_true",
                   help="multi-head models: report every head and their ensemble")
    p.add_argument("--mrfuse", action="store_true",
                   help="with --multiple_output: Weibull meta-recognition fusion of the "
                        "first three heads")
    p.add_argument("--head_weighting", type=str, default="mean",
                   choices=["mean", "magnitude"],
                   help="head ensemble of --multiple_output: the mean distmat (the "
                        "reference's active merge) or the per-pair max-norm weighting")
    p.add_argument("--rerank", action="store_true",
                   help="k-reciprocal re-ranking before the metrics (single-output "
                        "evaluation; query-query and gallery-gallery matrices are cosine "
                        "distances, as the query-gallery one)")
    p.add_argument("--sie_cameras", type=int, default=0,
                   help="SIE camera-embedding table size for TransReID backbones "
                        "(cfg.MODEL.SIE_CAMERA; must match the checkpoint)")
    p.add_argument("--sharded_eval", action=argparse.BooleanOptionalAction, default=None,
                   help="only --no-sharded_eval (the replicated path) is ported")
    p.add_argument("--sie_coef", type=float, default=1.5,
                   help="SIE embedding scale (sie_xishu; must match the checkpoint)")
    p.add_argument("--gelu_approx", action="store_true",
                   help="ViT family: tanh-approximate GELU in the MLP blocks (not the "
                        "reference's erf GELU)")
    p.add_argument("--quantize", type=str, default=None, choices=["int8"],
                   help="int8 post-training quantization for extraction: convolutions "
                        "(kernel conv_int8) and Dense layers of 128 or more on both sides "
                        "run int8, calibrated on the first batches (ops/quantize.py)")
    p.add_argument("--calib_batches", type=int, default=1,
                   help="int8 calibration spans the first N extract batches (running "
                        "absmax)")
    add_multihost_flags(p)
    add_device_flag(p)
    return p


def load_bundle(model_name: str, model_path: str | None, img_size, dtype: torch.dtype, device,
                **model_kw):
    """Build the model on ``device`` (init seeded with 12, the JAX CLI's key;
    ``model_kw`` to its factory, e.g. ``sie_cameras``,
    ``use_fused_attention``) and load ``model_path``: a JAX
    ``save_variables`` ``.npz`` or a reference torch ``state_dict`` pickle.
    Port of ``daliid_tpu/cli/evaluate.py::load_bundle`` (``:113``)."""
    bundle = get_model(model_name, torch.Generator().manual_seed(12), img_size=img_size,
                       dtype=dtype, device=device, **model_kw)
    if model_path:
        bundle.module.load_state_dict(load_state(model_name, model_path, bundle.module),
                                      strict=True)
        print(f"Loaded weights from {model_path}")
    return bundle


def check_transformer_flags(args) -> None:
    """The JAX CLI's refusals of the ViT-family flags (``:136-150``)."""
    if args.sie_cameras and args.model_name not in SIE_MODELS:
        raise SystemExit(f"--sie_cameras only applies to {sorted(SIE_MODELS)}; "
                         f"{args.model_name} has no SIE embedding")
    if args.gelu_approx and args.model_name not in GELU_APPROX_MODELS:
        raise SystemExit(f"--gelu_approx only applies to {sorted(GELU_APPROX_MODELS)}; "
                         f"{args.model_name} has no GELU")
    if args.sie_coef != 1.5 and not args.sie_cameras:
        raise SystemExit("--sie_coef only takes effect with --sie_cameras > 0; "
                         "without SIE embeddings the coefficient is unused")


def main(args):
    reject_unported(args, _UNPORTED)
    if args.sharded_eval:
        raise SystemExit("--sharded_eval is not yet ported to daliid_tpu_torch")
    reject_briar(*args.targets)
    check_transformer_flags(args)
    if args.head_weighting != "mean" and not args.multiple_output:
        raise SystemExit("--head_weighting applies only with --multiple_output")
    if args.rerank and (args.multiple_output or args.model_name in MULTIHEAD_MODELS):
        raise SystemExit("--rerank supports single-output evaluation only")
    device = resolve_device(args.device)
    img_size = (args.img_height, args.img_width)
    bundle = load_bundle(args.model_name, args.model_path, img_size,
                         parse_dtype(args.compute_dtype), device, sie_cameras=args.sie_cameras,
                         sie_coef=args.sie_coef, gelu_approx=args.gelu_approx)
    extractor = FeatureExtractor(bundle, img_size=img_size, batch_size=args.batch_size,
                                 device=device, quantize=args.quantize,
                                 calib_batches=args.calib_batches)
    results = {}
    for target in args.targets:
        splits = load_dataset(target, root=args.data_root)
        queries, gallery = splits["query"], splits["gallery"]
        if args.sie_cameras:
            check_camera_ids(args.sie_cameras, (queries, gallery), target)
        validator = get_validator(target, img_size=img_size, batch_size=args.batch_size,
                                  device=device, rerank=args.rerank)
        q_fvs = extractor.extract(queries, verbose=True)
        g_fvs = extractor.extract(gallery, verbose=True)

        def report(tag, distmat):
            cmc, mAP = validator.rank(distmat, queries, gallery)
            print(f"[{target}{tag}] mAP: {mAP:.2%}")
            for r in (1, 5, 10, 20):
                if r <= len(cmc):
                    print(f"[{target}{tag}] Rank-{r:<3}: {cmc[r - 1]:.2%}")
            return cmc, mAP

        if args.multiple_output and not isinstance(q_fvs, tuple):
            raise SystemExit(f"--multiple_output requires a multi-head model; "
                             f"{args.model_name} returns a single embedding")
        if args.multiple_output:
            distmats = []
            for h, (qh, gh) in enumerate(zip(q_fvs, g_fvs)):
                distmats.append(validator.distance_matrix(qh, gh))
                report(f":head{h}", distmats[-1])
            results[target] = report(":ensemble", validator.multihead_distance_matrix(
                q_fvs, g_fvs, args.head_weighting, distmats=distmats))
            if args.mrfuse and len(distmats) >= 3:
                fused_sim = mrfuse(*[1.0 - d for d in distmats[:3]])
                results[target + ":mrfuse"] = report(":mrfuse", 1.0 - fused_sim)
        else:  # a multi-head model without --multiple_output ranks its heads' mean
            results[target] = report("", validator.multihead_distance_matrix(q_fvs, g_fvs)
                                     if isinstance(q_fvs, tuple)
                                     else validator.reranked_distance_matrix(q_fvs, g_fvs,
                                                                            verbose=True))
    return results


if __name__ == "__main__":
    main(build_argparser().parse_args())
