"""Clean + distorted fusion evaluation CLI, the DaliID paper's test-time
method — port of ``daliid_tpu/cli/evaluate_fusion.py``.

Loads a clean-trained and a distortion-trained model of one backbone and
reports CMC/mAP, in the JAX CLI's order and under its tags, for every
fusion it evaluates: ``concat`` (the two embeddings concatenated),
``clean`` and ``distortion`` alone, ``average`` (the mean distmat) and
``magnitude_{gap,gmp,both}`` (the two distmats blended per pair by the
larger raw-embedding norm under that pooling). ``--roc_version`` writes
``FPR_/TPR_/Thresholds_<tag>.npy`` for the ``gap`` fusion. Every ranking
goes through kernel K2 on the device.

The pooling switch runs a shallow copy of the module with its own
``feature`` that shares the parameters, so no extractor sees its model's
pooling change. The ``both`` magnitudes reuse the base embeddings, which
the JAX CLI extracts again with the same numbers.

``--quantize int8`` extracts in int8, calibrated per (model, pooling) and
split, as the JAX CLI builds one extractor for each (``:105-123``); the
magnitude fusions then weigh raw int8 embedding norms. ``--dataset BRIAR``
with ``--train_file_path``, ``--queries_file_path`` and
``--gallery_file_path`` reads the ``.npy`` manifests
(:func:`~daliid_tpu_torch.data.briar.load_eval_splits`, JAX ``:91``). A
multi-split target (PRCC, VC-Clothes, ImageNet) is refused with an error
that names it: only ``evaluate`` ranks split by split. ``--multihost`` joins
a gang (:mod:`daliid_tpu_torch.parallel`): each rank extracts its block of
every batch, every rank ranks and prints the whole result, and rank 0
alone writes the ROC files. Flags are the JAX CLI's plus ``--device``.

Example::

    python -m daliid_tpu_torch evaluate-fusion --dataset Synthetic \\
        --model_path_clean clean.pt --model_path_distortion at.pt
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from daliid_tpu_torch.cli.common import refuse_multisplit
from daliid_tpu_torch.cli.evaluate import load_bundle
from daliid_tpu_torch.data.briar import load_eval_splits
from daliid_tpu_torch.device import add_device_flag, parse_dtype, resolve_device
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.eval.fusion import (
    average_distmats,
    concat_features_distmat,
    magnitude_weighted_distmat,
    magnitude_weights,
    roc_arrays,
    roc_curve,
)
from daliid_tpu_torch.eval.validate import Validator
from daliid_tpu_torch.metrics.ranking import cosine_distance_matrix
from daliid_tpu_torch.models.factory import ModelBundle
from daliid_tpu_torch.parallel.distributed import (
    add_multihost_flags,
    maybe_initialize_from_args,
    shutdown_multihost,
)
from daliid_tpu_torch.parallel.mesh import rank

def add_quantize_flags(p: argparse.ArgumentParser) -> None:
    """The two fusion CLIs' int8 extraction flags."""
    p.add_argument("--quantize", type=str, default=None, choices=["int8"],
                   help="int8 post-training quantization for extraction, calibrated per "
                        "model (and pooling) on its first batches (ops/quantize.py)")
    p.add_argument("--calib_batches", type=int, default=1,
                   help="int8 calibration spans the first N extract batches (running "
                        "absmax)")


def add_manifest_flags(p: argparse.ArgumentParser) -> None:
    """The two fusion CLIs' BRIAR manifest trio (``--dataset BRIAR``) and
    the multi-process flags."""
    p.add_argument("--train_file_path", type=str, default=None,
                   help="BRIAR dataset: training-manifest .npy")
    p.add_argument("--queries_file_path", type=str, default=None,
                   help="BRIAR dataset: probe-manifest .npy")
    p.add_argument("--gallery_file_path", type=str, default=None,
                   help="BRIAR dataset: gallery-manifest .npy")
    add_multihost_flags(p)


def eval_splits(args) -> dict:
    """The dataset's splits, or the BRIAR manifests'."""
    return load_eval_splits(args.dataset, root=args.data_root, train_npy=args.train_file_path,
                            queries_npy=args.queries_file_path,
                            gallery_npy=args.gallery_file_path)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DaliID clean+distorted fusion evaluation "
                                            "(PyTorch/CUDA)")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--model_name", type=str, default="resnet50")
    p.add_argument("--model_path_clean", type=str, default=None)
    p.add_argument("--model_path_distortion", type=str, default=None)
    p.add_argument("--img_height", type=int, default=256)
    p.add_argument("--img_width", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--roc_version", type=str, default=None,
                   help="dump FPR/TPR arrays with this tag")
    add_quantize_flags(p)
    add_manifest_flags(p)
    add_device_flag(p)
    return p


def report(tag: str, validator, distmat, queries, gallery, results: dict):
    """Rank ``distmat``, print the JAX CLI's lines and record
    ``results[tag]``; → (cmc, mAP)."""
    cmc, mAP = validator.rank(distmat, queries, gallery)
    print(f"[{tag}] mAP: {mAP:.2%}")
    for r in (1, 5, 10, 20):
        if r <= len(cmc):
            print(f"[{tag}] Rank-{r:<3}: {cmc[r - 1]:.2%}")
    results[tag] = {"mAP": float(mAP), "rank1": float(cmc[0])}
    return cmc, mAP


def with_pooling(bundle, pooling: str):
    """The bundle with its model's pooling set to ``pooling``: a shallow copy
    of the module that shares its parameters (the bundle itself is left as
    it is); a model without a pooling switch as it is."""
    module = bundle.module
    if getattr(module, "feature", pooling) == pooling:
        return bundle
    module = copy.copy(module)
    module.feature = pooling
    return ModelBundle(module=module, feature_dim=bundle.feature_dim, name=bundle.name)


def main(args):
    maybe_initialize_from_args(args)
    device = resolve_device(args.device)
    img_size = (args.img_height, args.img_width)
    dtype = parse_dtype(args.compute_dtype)
    splits = eval_splits(args)
    refuse_multisplit(args.dataset, splits, "evaluate-fusion")
    queries, gallery = splits["query"], splits["gallery"]
    clean = load_bundle(args.model_name, args.model_path_clean, img_size, dtype, device)
    dist = load_bundle(args.model_name, args.model_path_distortion, img_size, dtype, device)
    validator = Validator(img_size=img_size, batch_size=args.batch_size, device=device)
    results = {}

    def extract(bundle, pooling):
        # one extractor a split: each int8 extractor calibrates on its own split
        pooled = with_pooling(bundle, pooling)
        return tuple(torch.from_numpy(FeatureExtractor(
            pooled, img_size=img_size, batch_size=args.batch_size, device=device,
            quantize=args.quantize, calib_batches=args.calib_batches).extract(t)).to(device)
            for t in (queries, gallery))

    # base embeddings: "both" pooling, the training-time head
    (q_c, g_c), (q_d, g_d) = extract(clean, "both"), extract(dist, "both")
    report("concat", validator, concat_features_distmat(q_c, q_d, g_c, g_d), queries, gallery,
           results)
    d_clean, d_dist = cosine_distance_matrix(q_c, g_c), cosine_distance_matrix(q_d, g_d)
    report("clean", validator, d_clean, queries, gallery, results)
    report("distortion", validator, d_dist, queries, gallery, results)
    report("average", validator, average_distmats(d_clean, d_dist), queries, gallery, results)

    for pooling in ("gap", "gmp", "both"):
        if pooling == "both":
            feats = (q_c, g_c, q_d, g_d)
        else:
            feats = extract(clean, pooling) + extract(dist, pooling)
        fused = magnitude_weighted_distmat(d_clean, d_dist, *map(magnitude_weights, feats))
        report(f"magnitude_{pooling}", validator, fused, queries, gallery, results)
        if args.roc_version and pooling == "gap" and rank() == 0:
            fpr, tpr, thr = roc_curve(*roc_arrays(fused, queries.pids, gallery.pids))
            np.save(f"FPR_{args.roc_version}", fpr)
            np.save(f"TPR_{args.roc_version}", tpr)
            np.save(f"Thresholds_{args.roc_version}", thr)
            print("ROC Curve calculated!")
    return results


if __name__ == "__main__":
    main(build_argparser().parse_args())
    shutdown_multihost()
