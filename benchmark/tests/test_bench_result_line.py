"""The result line's shape, and a run without a card prints no result."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark import run as bench_run
from benchmark.harness import core, tracing


def _run(trace: bool) -> core.Run:
    manifest = core.load_manifest()
    entry, workload, config = bench_run.load_cell(manifest, "resnet50.train-market")
    run = core.Run(cell=entry["name"], workload=workload, config=config, seed=5, seconds=2.0,
                   trace=trace)
    run.metrics["train_img_s"] = 3000.5
    run.setup_s, run.window_s, run.attempted = 21.25, 10.5, 92
    run.counts.update(steps=92, epochs=2, valid_slots=30000, mined_images=25872, batch=384,
                      mining_batches=52)
    run.shapes.update(k1=(384, 256, 128), extract_batch=512)
    run.spans["proxy_mining"] = 2.5
    run.memory_peak_bytes = 14 << 30
    for name in workload["limits"]:
        run.check(name, 0.0)
    if trace:
        run.tracer = tracing.Trace(kernels=[("fused_augment_kernel", i * 1e3, 90.0)
                                            for i in range(92)],
                                   busy_s=9.0, window_s=10.5, device_ops=[["k", 1.0]],
                                   idle_gaps=[["cudaMemcpyAsync", 0.5]])
    return run


def test_trace0_line_has_the_contract_keys_and_checks_last():
    line = bench_run.result_line(core.load_manifest(), _run(False), "NVIDIA H100", 700.0)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_img_s.cnn", "setup_s"}
    assert line["metrics"]["train_img_s.cnn"] == {"value": 3000.5, "unit": "img/s"}
    assert line["metrics"]["setup_s"] == {"value": 21.25, "unit": "s"}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    json.dumps(line)


def test_trace1_line_has_per_layer_metrics_and_breakdown():
    line = bench_run.result_line(core.load_manifest(), _run(True), "NVIDIA H100", 700.0)
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert line["device"]["busy_s"] == 9.0 and line["device"]["window_s"] == 10.5
    m = line["metrics"]
    assert set(m) == {"mining_share.train_cnn", "train_mfu.cnn", "k1_roofline.train_cnn",
                      "device_idle.train_cnn"}
    assert abs(m["device_idle.train_cnn"]["value"] - 100 * (1 - 9.0 / 10.5)) < 1e-9
    assert 0 < m["k1_roofline.train_cnn"]["value"] <= 100


def test_a_failed_check_makes_the_run_incorrect():
    run = _run(False)
    run.checks[0].value = run.checks[0].limit * 2 + 1
    assert bench_run.result_line(core.load_manifest(), run, "x", None)["correct"] is False
    run = _run(False)
    run.checks[0].value = float("nan")
    assert bench_run.result_line(core.load_manifest(), run, "x", None)["correct"] is False


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return
    p = subprocess.run([sys.executable, str(core.BENCH / "run.py"), "--workload",
                        "resnet50.train-market", "--seed", "1", "--seconds", "1", "--trace",
                        "0"], capture_output=True, text=True, cwd=core.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
