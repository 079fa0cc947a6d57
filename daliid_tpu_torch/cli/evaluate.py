"""Single-model evaluation CLI on the GPU — port of ``daliid_tpu/cli/evaluate.py``.

Loads a backbone and weights, extracts query and gallery embeddings, builds
the cosine distance matrix on the device and ranks CMC/mAP through kernel
K2. Flags are the JAX CLI's (``:31-110``) plus ``--device``, with its
checks (``:136-170``, ``:203-216``): ``--sie_cameras`` and ``--sie_coef``
for the SIE models, ``--gelu_approx`` for the ViT family,
``--head_weighting`` only with ``--multiple_output``, the BRIAR manifest
trio together and only with the ``BRIAR`` target.

Each target is a registered dataset, or ``BRIAR`` read from the three
``.npy`` manifests (``--train_file_path``, ``--queries_file_path``,
``--gallery_file_path``) and ranked with the standard protocol
(``:186-217``). A multi-split protocol (PRCC's 10 gallery splits and 3
query sets, VC-Clothes, ImageNet) ranks every (query set, gallery split)
pair and reports the mean over the gallery splits under ``<target>:q<i>``
(``:229-255``); each gallery split is extracted once, after query set 0,
which stays the first extraction (``--quantize int8`` calibrates on it).
``--turbulence_dir_path`` with ``--turbulence_strength`` ranks clean
queries against the gallery's turbulence copies at that strength
(``:257-263``). A multi-head model with ``--multiple_output`` reports each
head, then the heads' ensemble (``--head_weighting``), then with
``--mrfuse`` the meta-recognition fusion of the first three heads'
similarities (``:278-317``, the replicated path). ``--rerank`` applies
k-reciprocal re-ranking before the metrics (``:225``, ``:323``),
single-output evaluation only, as in JAX. ``--quantize int8`` extracts in
int8 (``--calib_batches`` of calibration).

``--multihost`` (with ``--coordinator_address``, ``--num_processes`` and
``--process_id``) joins a gang (:mod:`daliid_tpu_torch.parallel`): every
rank extracts its block of each batch and holds the whole embeddings.
``--sharded_eval`` (``:80-83``, ``:226``, ``:283-321``; the default turns it
on in a gang of more than one rank) ranks each rank's block of the queries
against the whole gallery, ``query_chunk`` rows at a time, and merges the
sums over the gang, so no (Q, G) matrix is built; with
``--multiple_output`` (not ``--mrfuse``) each head and the heads' ensemble
rank that way too. Every rank prints the metrics; this CLI writes no file.

Example::

    python -m daliid_tpu_torch.cli.evaluate --targets Synthetic --data_root /tmp/dd \\
        --model_name resnet50 --model_path weights.npz
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from daliid_tpu_torch.cli.common import check_camera_ids
from daliid_tpu_torch.data.briar import load_eval_splits
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
from daliid_tpu_torch.parallel.distributed import (
    add_multihost_flags,
    maybe_initialize_from_args,
    shutdown_multihost,
)

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
    p.add_argument("--turbulence_dir_path", type=str, default=None,
                   help="rank against the gallery's turbulence copies in this directory")
    p.add_argument("--turbulence_strength", type=int, default=None,
                   help="strength (1-5) of the gallery's turbulence copies")
    p.add_argument("--train_file_path", type=str, default=None,
                   help="BRIAR target: training-manifest .npy")
    p.add_argument("--queries_file_path", type=str, default=None,
                   help="BRIAR target: probe-manifest .npy")
    p.add_argument("--gallery_file_path", type=str, default=None,
                   help="BRIAR target: gallery-manifest .npy")
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
                   help="rank each rank's block of the queries in chunks, with no whole "
                        "(Q, G) distmat (default: on in a gang of more than one rank; "
                        "--no-sharded_eval forces the replicated distmat)")
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


def check_manifest_flags(args) -> tuple:
    """The BRIAR manifest trio: all three or none, and only with the BRIAR
    target (JAX ``:153-168``) → the three paths."""
    paths = (args.train_file_path, args.queries_file_path, args.gallery_file_path)
    if any(paths):
        if not all(paths):
            raise SystemExit("--train_file_path/--queries_file_path/--gallery_file_path "
                             "must be given together (evaluate.py:77)")
        if "BRIAR" not in args.targets:
            raise SystemExit("manifest paths are consumed by the BRIAR target only — "
                             "add BRIAR to --targets (evaluate.py:130-136)")
    return paths


def rank_multisplit(target, extractor, validator, queries, gallery, results) -> None:
    """Every (query set, gallery split) pair; the mean rank-1 and mAP over
    the gallery splits of each query set go to ``results["<target>:q<i>"]``.
    Each split is extracted once, query set 0 first."""
    galleries = gallery if isinstance(gallery, list) else [gallery]
    query_sets = queries if isinstance(queries, list) else [queries]
    q_fvs = [extractor.extract(query_sets[0], verbose=False)]
    g_fvs = [extractor.extract(g, verbose=False) for g in galleries]
    q_fvs += [extractor.extract(q, verbose=False) for q in query_sets[1:]]
    for qi, (qset, qf) in enumerate(zip(query_sets, q_fvs)):
        r1s, maps = [], []
        for gset, gf in zip(galleries, g_fvs):
            cmc, mAP = validator.rank_features(qf, gf, qset, gset)
            r1s.append(float(cmc[0]))
            maps.append(float(mAP))
        print(f"[{target}:q{qi}] mean over {len(galleries)} gallery splits: "
              f"mAP {np.mean(maps):.2%}  Rank-1 {np.mean(r1s):.2%}")
        results[f"{target}:q{qi}"] = (float(np.mean(r1s)), float(np.mean(maps)))


def main(args):
    maybe_initialize_from_args(args)
    check_transformer_flags(args)
    if args.rerank and (args.multiple_output or args.model_name in MULTIHEAD_MODELS):
        raise SystemExit("--rerank supports single-output evaluation only")
    manifests = check_manifest_flags(args)
    if args.head_weighting != "mean" and not args.multiple_output:
        raise SystemExit("--head_weighting applies only with --multiple_output")
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
        splits = load_eval_splits(target, args.data_root,
                                  *(manifests if target == "BRIAR" else (None,) * 3))
        queries, gallery = splits["query"], splits["gallery"]
        if args.sie_cameras:
            check_camera_ids(args.sie_cameras, (queries, gallery), target)
        # the manifests rank with the standard protocol (evaluate.py:318-330)
        validator = get_validator("standard" if target == "BRIAR" else target,
                                  img_size=img_size, batch_size=args.batch_size,
                                  device=device, rerank=args.rerank, sharded=args.sharded_eval)
        if isinstance(gallery, list) or isinstance(queries, list):
            if args.multiple_output:
                raise SystemExit(f"--multiple_output is not supported on multi-split targets "
                                 f"({target}); evaluate per head instead")
            rank_multisplit(target, extractor, validator, queries, gallery, results)
            continue
        q_fvs = extractor.extract(queries, verbose=True)
        g_fvs = extractor.extract(gallery, turbulence_dir=args.turbulence_dir_path,
                                  turb_strength=args.turbulence_strength, dataset=target,
                                  verbose=True)

        def report_metrics(tag, cmc, mAP):
            print(f"[{target}{tag}] mAP: {mAP:.2%}")
            for r in (1, 5, 10, 20):
                if r <= len(cmc):
                    print(f"[{target}{tag}] Rank-{r:<3}: {cmc[r - 1]:.2%}")
            return cmc, mAP

        def report(tag, distmat):
            return report_metrics(tag, *validator.rank(distmat, queries, gallery))

        if args.multiple_output and not isinstance(q_fvs, tuple):
            raise SystemExit(f"--multiple_output requires a multi-head model; "
                             f"{args.model_name} returns a single embedding")
        sharded = validator.sharded_active()
        if args.multiple_output and sharded and not args.mrfuse:
            # each head and the heads' ensemble without a (Q, G) matrix
            for h, (qh, gh) in enumerate(zip(q_fvs, g_fvs)):
                report_metrics(f":head{h}", *validator.rank_features(qh, gh, queries, gallery))
            results[target] = report_metrics(":ensemble (sharded)", *validator.rank_features(
                q_fvs, g_fvs, queries, gallery, head_weighting=args.head_weighting))
        elif args.multiple_output:
            distmats = []
            for h, (qh, gh) in enumerate(zip(q_fvs, g_fvs)):
                distmats.append(validator.distance_matrix(qh, gh))
                report(f":head{h}", distmats[-1])
            results[target] = report(":ensemble", validator.multihead_distance_matrix(
                q_fvs, g_fvs, args.head_weighting, distmats=distmats))
            if args.mrfuse and len(distmats) >= 3:
                fused_sim = mrfuse(*[1.0 - d for d in distmats[:3]])
                results[target + ":mrfuse"] = report(":mrfuse", 1.0 - fused_sim)
        elif sharded:  # distance rows stay with each rank's block of the queries
            results[target] = report_metrics(" (sharded)", *validator.rank_features(
                q_fvs, g_fvs, queries, gallery))
        else:  # a multi-head model without --multiple_output ranks its heads' mean
            results[target] = report("", validator.multihead_distance_matrix(q_fvs, g_fvs)
                                     if isinstance(q_fvs, tuple)
                                     else validator.reranked_distance_matrix(q_fvs, g_fvs,
                                                                            verbose=True))
    return results


if __name__ == "__main__":
    main(build_argparser().parse_args())
    shutdown_multihost()
