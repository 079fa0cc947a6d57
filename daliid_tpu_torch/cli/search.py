"""Identification-service CLI: enroll a gallery, search probes — port of
``daliid_tpu/cli/search.py`` (``:33-136``).

Builds a device-resident gallery index from a dataset split (or a saved
``.npz``) and answers the query split's probes with ranked identities
through kernel K3. ``--rerank`` re-orders each probe's top
``--rerank_depth`` shortlist by k-reciprocal re-ranking (exact f32 even on
an int8 index; scores become 1 - re-ranked distance). Flags are the JAX
CLI's plus ``--device``: ``--quantize int8`` extracts in int8 (apart from
``--index_quantize``, which stores the index in int8); the multi-host flags
name a feature not ported yet and exit with an error.

Example::

    python -m daliid_tpu_torch.cli.search --dataset Synthetic --data_root /tmp/dd \\
        --model_name resnet50 --index_quantize int8 --topk 10
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from daliid_tpu_torch.cli.common import MULTIHOST_FLAGS, add_multihost_flags, reject_unported
from daliid_tpu_torch.cli.evaluate import load_bundle
from daliid_tpu_torch.data.registry import load_dataset
from daliid_tpu_torch.device import add_device_flag, parse_dtype, resolve_device
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.eval.matcher import GalleryIndex

_UNPORTED = MULTIHOST_FLAGS


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DaliID gallery search service (PyTorch/CUDA)")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--model_name", type=str, default="resnet50")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--img_height", type=int, default=256)
    p.add_argument("--img_width", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--quantize", type=str, default=None, choices=["int8"],
                   help="int8 post-training quantization for extraction, calibrated "
                        "lazily on the first batches (ops/quantize.py)")
    p.add_argument("--calib_batches", type=int, default=1,
                   help="int8 calibration spans the first N extract batches (running "
                        "absmax)")
    p.add_argument(
        "--index_quantize", type=str, default=None, choices=["int8", "off"],
        help="'int8' stores the device gallery as per-row symmetric int8; "
             "'off' forces f32 when --load_index carries a saved int8 mode; "
             "default keeps the saved mode (f32 for fresh galleries)",
    )
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--rerank", action="store_true",
                   help="k-reciprocal re-rank of each probe's top shortlist (exact f32 "
                        "even on an int8 index); scores become 1 - re-ranked distance")
    p.add_argument("--rerank_depth", type=int, default=64,
                   help="shortlist length fed to --rerank")
    p.add_argument("--save_index", type=str, default=None, help="save gallery embeddings to .npz")
    p.add_argument("--load_index", type=str, default=None, help="load gallery embeddings from .npz")
    p.add_argument("--max_probes", type=int, default=0, help="limit probes (0 = all)")
    add_multihost_flags(p)
    add_device_flag(p)
    return p


def main(args):
    reject_unported(args, _UNPORTED)
    device = resolve_device(args.device)
    img_size = (args.img_height, args.img_width)
    splits = load_dataset(args.dataset, root=args.data_root)
    gallery, queries = splits["gallery"], splits["query"]

    bundle = load_bundle(args.model_name, args.model_path, img_size,
                         parse_dtype(args.compute_dtype), device)
    extractor = FeatureExtractor(bundle, img_size=img_size, batch_size=args.batch_size,
                                 device=device, quantize=args.quantize,
                                 calib_batches=args.calib_batches)

    flag = args.index_quantize
    index_quantize = None if flag == "off" else flag
    if args.load_index:
        # an explicit --index_quantize overrides the saved mode
        index = GalleryIndex.load(args.load_index,
                                  quantize="auto" if flag is None else index_quantize,
                                  device=device)
        print(f"Loaded index: {index.num_gallery} entries from {args.load_index}")
    else:
        g_fvs = extractor.extract(gallery, verbose=True)
        index = GalleryIndex(g_fvs, gallery_pids=gallery.pids, quantize=index_quantize,
                             device=device)
        if args.save_index:
            index.save(args.save_index)
            print(f"Saved index ({index.num_gallery} entries) to {args.save_index}")

    probes = queries if not args.max_probes else queries[np.arange(args.max_probes)]
    q_fvs = extractor.extract(probes, verbose=True)
    t0 = time.time()
    sims, ids, pids = index.search(q_fvs, k=args.topk, rerank=args.rerank,
                                   rerank_depth=args.rerank_depth)
    dt = time.time() - t0
    acc_note = ""
    if pids is not None:
        acc_note = (f"; top-1 identity accuracy "
                    f"{float(np.mean(pids[:, 0] == probes.pids)):.2%}")
    print(
        f"searched {len(probes)} probes over {index.num_gallery} gallery in "
        f"{dt * 1e3:.1f} ms ({len(probes) / max(dt, 1e-9):.0f} probes/s)"
        + acc_note
    )
    for i in range(min(3, len(probes))):
        hits = pids[i].tolist() if pids is not None else ids[i].tolist()
        label = "pids" if pids is not None else "gallery rows"
        print(f"probe {i} (pid {probes.pids[i]}): top-{args.topk} {label} {hits}")
    return sims, ids, pids


if __name__ == "__main__":
    main(build_argparser().parse_args())
