"""The control at a tiny size on the CPU: the float8 reference in the
program's place for a training cell, and the program's own int8 extraction
for an evaluation cell; each reads numbers above what a sound run reads."""

from __future__ import annotations

import copy

from benchmark.harness import core
from benchmark.tests.tiny import TREES, numbers, tiny_run


def test_train_control_reads_above_the_program(tmp_path):
    import benchmark.control as control

    sound = numbers(tiny_run("resnet50.train-market", tmp_path / "a"))
    wl = copy.deepcopy(core.load_json("workloads", "resnet50.train-market"))
    cfg = copy.deepcopy(core.load_json("configs", "resnet50"))
    wl["params"]["tree"] = TREES["train_epochs"][0]
    wl["params"].update(TREES["train_epochs"][1])
    cfg["img_size"] = [64, 32]
    run = core.Run(cell=wl["name"], workload=wl, config=cfg, seed=2 ** 31 + 5, seconds=0.1,
                   trace=False, device="cpu", cache=tmp_path / "b")
    control.train_control(run)
    low = numbers(run)
    assert low["mining_embed_gap"] > 2 * sound["mining_embed_gap"]
    assert not all(c.ok for c in run.checks)


def test_eval_control_is_the_programs_int8_path(tmp_path):
    sound = numbers(tiny_run("transreid_jpm.eval-market", tmp_path / "a"))
    low = tiny_run("transreid_jpm.eval-market", tmp_path / "b", quantize="int8")
    assert numbers(low)["embed_gap"] > 2 * sound["embed_gap"]
    assert not all(c.ok for c in low.checks)
