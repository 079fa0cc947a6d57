#!/usr/bin/env python3
"""Read a cell's compared numbers for its control or for a planted fault, on
several seeds, in one process.

    python benchmark/control.py --workload <cell> --seeds 11,12,13 --mode control
    python benchmark/control.py --workload <cell> --seeds 11,12,13 --mode control_window
    python benchmark/control.py --workload <cell> --seeds 11,12,13 --mode half_batch

``control`` puts the next precision below the configuration's in the
program's place: for a training cell the reference itself, computed with
float8 operands (:mod:`benchmark.reference.precision`), follows the same
batches as the program would; for an evaluation or serving cell the
program's own int8 extraction path (``quantize='int8'``) runs the cell.
``control_window`` runs a training cell's program through its window and
reads the window's mining with the float8 reference's embeddings, from the
same trained weights, in the program's place.
A fault name (``stale_state``, ``half_batch``, ``altered_answer``) runs the
cell's program with that fault planted in its timed path. Each seed prints
one JSON line of the numbers and their limits. The benchmark's own runs
never run this; the limits in the workload files were set from it.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
os.environ["USE_FLAX"] = "0"
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))


def train_control(run) -> None:
    """The float8 reference in the program's place for a training cell."""
    import numpy as np
    import torch

    from daliid_tpu_torch.data.registry import parse_market_duke_dir
    from daliid_tpu_torch.train.sampler import PKBatchSampler
    from benchmark.harness import compare, models
    from benchmark.reference import mining as ref_mining
    from benchmark.reference.precision import Precision, set_strict_float32
    from benchmark.traffic import train_epochs as te

    set_strict_float32()
    p, cfg = run.params, run.config
    dev = torch.device(run.device)
    root = te.make_tree(run)
    table = parse_market_duke_dir(os.path.join(root, "bounding_box_train"))
    sampler = PKBatchSampler(table, table.pids, P=p["P"], K=p["K"],
                             kind_of_transform=p["kind_of_transform"],
                             turbulence_dir=os.path.join(root, "turbulence"), dataset="Market",
                             seed=run.seed)
    batches = []
    for b in sampler.epoch():
        batches.append(b)
        if len(batches) == te.CHECK_STEPS:
            break
    weights = models.make_weights(cfg, run.seed, dev)
    low, f32 = Precision("fp8"), Precision("f32")
    paths = [str(x) for x in table.paths]
    feats = te.reference_embed(run, weights, paths, low)
    class_idx = np.asarray([sampler.label_to_class[l] for l in sampler.labels], np.int32)
    pset = ref_mining.mine(feats, class_idx, sampler.num_classes,
                           p["trainer"]["num_proxies"], np.random.default_rng(run.seed))
    prog = te.reference_side(run, weights, batches, pset, low)
    ref = te.reference_side(run, weights, batches, pset, f32)
    compare.train_numbers(run, prog, ref)
    rows = np.random.default_rng(run.seed).choice(len(table), p["check_rows"], replace=False)
    run.check("mining_embed_gap", compare.row_gap(
        feats[rows], te.reference_embed(run, weights, [paths[i] for i in rows], f32)))
    run.check("mining_pset_gap", 0.0)


def main() -> int:
    from benchmark.harness import core

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="control")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    base = core.load_json("workloads", args.workload)
    config = core.load_json("configs", base["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        wl = copy.deepcopy(base)
        run = core.Run(cell=args.workload, workload=wl, config=config, seed=seed,
                       seconds=args.seconds, trace=False)
        if args.mode == "control" and wl["kind"] == "train_epochs":
            train_control(run)
        else:
            if args.mode == "control_window":
                run.control = True
            elif args.mode == "control":
                wl["params"]["quantize"] = "int8"
            else:
                run.fault = args.mode
            core.traffic_driver(wl["kind"]).run(run)
        print(json.dumps({"seed": seed, "mode": args.mode, "correct": all(c.ok for c in run.checks),
                          "checks": {c.name: {"value": c.value, "limit": c.limit}
                                     for c in run.checks}}), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
