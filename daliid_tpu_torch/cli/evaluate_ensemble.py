"""Two-model ensemble evaluation CLI — port of
``daliid_tpu/cli/evaluate_ensemble.py``.

Loads two trained models, possibly of different backbones, ranks each
one's cosine distmat and then their mean, through kernel K2 on the device,
and returns ``{model01, model02, ensemble}`` with each one's rank-1 and
mAP. ``--quantize int8`` extracts in int8, each model's extractor
calibrated on its first batches (the queries). Flags are the JAX CLI's plus
``--device``; the BRIAR manifests and the multi-host flags exit with an
error that names them.

Example::

    python -m daliid_tpu_torch evaluate-ensemble --dataset Synthetic \\
        --model_name01 resnet50 --model_name02 resnet50IBN
"""

from __future__ import annotations

import argparse

import torch

from daliid_tpu_torch.cli.common import reject_briar, reject_unported
from daliid_tpu_torch.cli.evaluate import load_bundle
from daliid_tpu_torch.cli.evaluate_fusion import (
    UNPORTED,
    add_quantize_flags,
    add_unported_flags,
)
from daliid_tpu_torch.data.registry import load_dataset
from daliid_tpu_torch.device import add_device_flag, parse_dtype, resolve_device
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.eval.fusion import average_distmats
from daliid_tpu_torch.eval.validate import get_validator
from daliid_tpu_torch.metrics.ranking import cosine_distance_matrix


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
    add_unported_flags(p)
    add_device_flag(p)
    return p


def main(args):
    reject_unported(args, UNPORTED)
    reject_briar(args.dataset)
    device = resolve_device(args.device)
    img_size = (args.img_height, args.img_width)
    dtype = parse_dtype(args.compute_dtype)
    splits = load_dataset(args.dataset, root=args.data_root)
    queries, gallery = splits["query"], splits["gallery"]
    validator = get_validator(args.dataset, img_size=img_size, batch_size=args.batch_size,
                              device=device)
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
