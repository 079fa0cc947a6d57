"""Two-model ensemble evaluation CLI — port of
``daliid_tpu/cli/evaluate_ensemble.py``.

Loads two trained models, possibly of different backbones, ranks each
one's cosine distmat and then their mean, through kernel K2 on the device,
and returns ``{model01, model02, ensemble}`` with each one's rank-1 and
mAP. ``--quantize int8`` extracts in int8, each model's extractor
calibrated on its first batches (the queries). ``--dataset BRIAR`` with
the three manifest flags reads the ``.npy`` manifests and ranks with the
standard protocol (JAX ``:62-72``). A multi-split target (PRCC,
VC-Clothes, ImageNet) is refused with an error that names it: only
``evaluate`` ranks split by split. ``--multihost`` joins a gang
(:mod:`daliid_tpu_torch.parallel`): each rank extracts its block of every
batch, and every rank ranks and prints the whole result. Flags are the JAX
CLI's plus ``--device``.

Example::

    python -m daliid_tpu_torch evaluate-ensemble --dataset Synthetic \\
        --model_name01 resnet50 --model_name02 resnet50IBN
"""

from __future__ import annotations

import argparse

import torch

from daliid_tpu_torch.cli.common import refuse_multisplit
from daliid_tpu_torch.cli.evaluate import load_bundle
from daliid_tpu_torch.cli.evaluate_fusion import add_manifest_flags, add_quantize_flags, eval_splits
from daliid_tpu_torch.device import add_device_flag, parse_dtype, resolve_device
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.eval.fusion import average_distmats
from daliid_tpu_torch.eval.validate import get_validator
from daliid_tpu_torch.metrics.ranking import cosine_distance_matrix
from daliid_tpu_torch.parallel.distributed import maybe_initialize_from_args, shutdown_multihost


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DaliID two-model ensemble evaluation "
                                            "(PyTorch/CUDA)")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--model_name01", type=str, default="resnet50")
    p.add_argument("--model_name02", type=str, default="resnet50")
    p.add_argument("--model_path01", type=str, default=None)
    p.add_argument("--model_path02", type=str, default=None)
    p.add_argument("--img_height", type=int, default=256)
    p.add_argument("--img_width", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    add_quantize_flags(p)
    add_manifest_flags(p)
    add_device_flag(p)
    return p


def main(args):
    maybe_initialize_from_args(args)
    device = resolve_device(args.device)
    img_size = (args.img_height, args.img_width)
    dtype = parse_dtype(args.compute_dtype)
    splits = eval_splits(args)
    refuse_multisplit(args.dataset, splits, "evaluate-ensemble")
    queries, gallery = splits["query"], splits["gallery"]
    # the manifests rank with the standard protocol (evaluate_ensembled_models.py:318-330)
    validator = get_validator("standard" if args.dataset == "BRIAR" else args.dataset,
                              img_size=img_size, batch_size=args.batch_size, device=device)
    results = {}
    distmats = []
    for tag, name, path in (("model01", args.model_name01, args.model_path01),
                            ("model02", args.model_name02, args.model_path02)):
        ex = FeatureExtractor(load_bundle(name, path, img_size, dtype, device),
                              img_size=img_size, batch_size=args.batch_size, device=device,
                              quantize=args.quantize, calib_batches=args.calib_batches)
        q, g = (torch.from_numpy(ex.extract(t, verbose=True)).to(device)
                for t in (queries, gallery))
        distmats.append(cosine_distance_matrix(q, g))
        cmc, mAP = validator.rank(distmats[-1], queries, gallery)
        print(f"[{tag}] mAP: {mAP:.2%} Rank-1: {cmc[0]:.2%}")
        results[tag] = {"mAP": float(mAP), "rank1": float(cmc[0])}

    cmc, mAP = validator.rank(average_distmats(*distmats), queries, gallery)
    print(f"[ensemble] mAP: {mAP:.2%} Rank-1: {cmc[0]:.2%}")
    results["ensemble"] = {"mAP": float(mAP), "rank1": float(cmc[0])}
    return results


if __name__ == "__main__":
    main(build_argparser().parse_args())
    shutdown_multihost()
