"""A cell, a configuration (with a model of its own) and a per-layer metric
added as files, with entries in BENCHMARK.json, are found with no edit to
any harness file; a configuration's widths reach both sides."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import core, models
from benchmark.tests.tiny import numbers, tiny_workload

# a model the harness has never seen: its reference module, written as a file
TOY_MODEL = '''
import torch


def spec(cfg):
    return [("proj.weight", (cfg["feature_dim"], 3 * cfg["pool"] ** 2), "fan_in")]


def forward(cfg, P, x, train=False, prec=None, generator=None):
    x = torch.nn.functional.adaptive_avg_pool2d(x, cfg["pool"]).flatten(1)
    return x @ P["proj.weight"].T


def flops(cfg, train=False):
    return 2.0 * cfg["feature_dim"] * 3 * cfg["pool"] ** 2


def attention(cfg):
    return []
'''


@pytest.fixture
def copy_of_benchmark(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    for sub in ("workloads", "configs", "layer_metrics", "roofline", "reference"):
        shutil.copytree(core.BENCH / sub, bench / sub)
    manifest = core.load_manifest()
    monkeypatch.setattr(core, "BENCH", bench)
    monkeypatch.setattr(core, "ROOT", tmp_path)
    return bench, manifest


def _add(manifest, bench, config: dict, cell: str, workload_from: str) -> None:
    (bench / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    wl = json.loads((bench / "workloads" / f"{workload_from}.json").read_text())
    traffic = cell.split(".", 1)[1]
    wl.update(name=cell, config=config["name"], traffic=traffic)
    (bench / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
    manifest["configs"].append({"name": config["name"], "source": "https://example.org",
                                "file": f"benchmark/configs/{config['name']}.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": cell, "config": config["name"], "traffic": traffic,
                                  "chips": 1, "why": "a test"})


def test_new_cell_config_and_metric_are_found(copy_of_benchmark):
    bench, manifest = copy_of_benchmark
    (bench / "reference" / "toy.py").write_text(TOY_MODEL)
    toy = {"name": "toy", "model": "toy", "img_size": [64, 32], "compute_dtype": "float32",
           "pool": 4, "feature_dim": 8, "reference": "benchmark/reference/toy.py",
           "program": {"factory": "toy"}, "reduced": [], "assumed": []}
    _add(manifest, bench, toy, "toy.train-small", "resnet50.train-market")
    (bench / "layer_metrics" / "steps_per_epoch.train.py").write_text(
        "def read(run):\n    return run.counts['steps'] / run.counts['epochs']\n")
    manifest["end_to_end"][0]["workloads"].append("toy.train-small")
    moves = manifest["end_to_end"][0]["name"]
    manifest["per_layer"].append({"name": "steps_per_epoch.train", "unit": "steps",
                                  "better": "higher", "source": "program_counter",
                                  "layer": "epoch loop", "moves": moves})
    entry, workload, config = bench_run.load_cell(manifest, "toy.train-small")
    assert config["name"] == "toy" and workload["kind"] == "train_epochs"
    assert core.traffic_driver(workload["kind"]).run
    # the model is read from its own reference file
    ref = models.reference(config)
    assert [n for n, _, _ in ref.spec(config)] == ["proj.weight"]
    w = models.make_weights(config, 3, "cpu")
    assert ref.forward(config, w, torch.zeros(2, 3, 64, 32)).shape == (2, 8)
    names = [m["name"] for m in core.metrics_of(manifest, "toy.train-small", "per_layer")]
    # a metric without a list reaches every cell that reports what it moves
    assert "steps_per_epoch.train" in names
    assert "steps_per_epoch.train" in [m["name"] for m in core.metrics_of(
        manifest, "resnet50.train-market", "per_layer")]
    assert "steps_per_epoch.train" not in [m["name"] for m in core.metrics_of(
        manifest, "transreid_jpm.eval-market", "per_layer")]
    run = core.Run(cell="toy.train-small", workload=workload, config=config, seed=1,
                   seconds=1.0, trace=True)
    run.window_s = 2.0
    run.counts.update(steps=92, epochs=2, valid_slots=1000, mined_images=500)
    out = bench_run.per_layer(manifest, run)
    assert out["steps_per_epoch.train"] == {"value": 46.0, "unit": "steps"}
    # the family's mfu reader counts the toy's FLOPs from its file
    mfu = next(m["name"] for m in manifest["per_layer"]
               if m["name"].startswith("train_mfu") and "toy.train-small" not in m["workloads"])
    assert out.get(mfu) is None
    want = 100 * 2.0 * 8 * 48 * (3 * 1000 + 500) / (2.0 * 989e12)
    assert models.reference(config).flops(config) == 2.0 * 8 * 48
    from benchmark.roofline.reading import train_mfu
    assert train_mfu(run) == pytest.approx(want)


def test_a_transformer_at_other_widths_runs_as_a_new_configuration(copy_of_benchmark,
                                                                    tmp_path):
    """A new configuration file at other widths, with its cell, drives the
    training path end to end: the program builds those widths and the
    reference follows them."""
    bench, manifest = copy_of_benchmark
    cfg = json.loads((bench / "configs" / "transreid_jpm.json").read_text())
    cfg.update(name="transreid_jpm_narrow", img_size=[64, 32], embed_dim=48, depth=2,
               num_heads=3, mlp_ratio=2.0, num_classes=8, feature_dim=5 * 48)
    _add(manifest, bench, cfg, "transreid_jpm_narrow.train-small", "transreid_jpm.train-market")
    entry, workload, config = bench_run.load_cell(manifest, "transreid_jpm_narrow.train-small")
    wl = dict(workload, params=tiny_workload("transreid_jpm.train-market")["params"])
    run = core.Run(cell=entry["name"], workload=wl, config=config, seed=2 ** 33 + 1,
                   seconds=0.1, trace=False, device="cpu", cache=tmp_path / "cache")
    core.traffic_driver(wl["kind"]).run(run)
    got = numbers(run)
    # (the cell's limits are set for the published widths at full size)
    assert set(got) == set(workload["limits"]) and all(v == v for v in got.values())
    assert got["mining_pset_gap"] == 0.0 and got["mining_embed_gap"] < 0.1
    assert run.shapes["attention"] == [(2, 1 + 5 * 2, 3, 16), (4, 1 + 10 // 4, 3, 16)]


def test_every_manifest_entry_has_its_files():
    manifest = core.load_manifest()
    for w in manifest["workloads"]:
        entry, workload, config = bench_run.load_cell(manifest, w["name"])
        assert workload["name"] == w["name"] and config["name"] == w["config"]
        assert set(workload["limits"]) and core.traffic_driver(workload["kind"]).run
    for m in manifest["per_layer"]:
        assert core.metric_reader(m["name"]).read
    for c in manifest["configs"]:
        assert (core.ROOT / c["file"]).is_file()
