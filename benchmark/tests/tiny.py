"""Tiny versions of the cells, for the CPU: the cell's kind, limits and
configuration with a few identities, small images and a small batch."""

from __future__ import annotations

import copy

from benchmark.harness import core

TREES = {
    "train_epochs": ({"identities": {"train": 8},
                      "splits": {"bounding_box_train": ["train", 48, 3, 9]},
                      "cams": 6, "height": 32, "width": 16,
                      "renders": ["bounding_box_train"]},
                     dict(P=2, K=2, check_rows=16)),
    "evaluate_protocol": ({"identities": {"test": 6},
                           "splits": {"query": ["test", 12, 1, 3],
                                      "bounding_box_test": ["test", 40, 3, 9]},
                           "distractors": {"bounding_box_test": 20}, "cams": 6, "height": 32,
                           "width": 16, "renders": []},
                          dict(batch_size=16, check_rows=16)),
}
SECONDS = {"train_epochs": 0.1, "evaluate_protocol": 0.5}


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(core.load_json("configs", name))
    cfg["img_size"] = [64, 32]
    if cfg.get("num_classes"):
        cfg["num_classes"] = 8
    return cfg


def tiny_workload(cell: str, **params) -> dict:
    wl = copy.deepcopy(core.load_json("workloads", cell))
    tree, small = TREES[wl["kind"]]
    wl["params"]["tree"] = tree
    wl["params"].update(small, **params)
    if wl["kind"] == "train_epochs":
        wl["params"]["trainer"]["extractor_batch"] = 16
    return wl


def tiny_run(cell: str, cache, fault: str | None = None, seed: int = 2 ** 31 + 5,
             **params) -> core.Run:
    wl = tiny_workload(cell, **params)
    cfg = tiny_config(wl["config"])
    run = core.Run(cell=cell, workload=wl, config=cfg, seed=seed, seconds=SECONDS[wl["kind"]],
                   trace=False, device="cpu", cache=cache, fault=fault)
    core.traffic_driver(wl["kind"]).run(run)
    return run


def numbers(run) -> dict:
    return {c.name: c.value for c in run.checks}
