#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
The cell's files are found by name (see ``benchmark/harness/core.py``); the
traffic kind's driver builds the program from the seed, warms up, runs the
window for ``--seconds`` and compares what the window produced with the
plain reference. With ``--trace 0`` the result line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from
torch.profiler's trace of the window and the harness's own spans and counts.
The last line of standard output is the result; the compared numbers, each
with its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
# every cache of the program and of its compilers inside the checkout, at a
# fixed path, before torch is imported
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(_ROOT / "build" / "benchmark" / "cache" / _sub)
os.environ["USE_FLAX"] = "0"
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

from benchmark.harness import core  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_cell(manifest: dict, name: str) -> tuple:
    """The cell's manifest entry, workload file and configuration file, which
    must agree."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    workload = core.load_json("workloads", name)
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"{key} of {name}: {workload[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    return entry, workload, core.load_json("configs", entry["config"])


def per_layer(manifest: dict, run) -> dict:
    out = {}
    for m in core.metrics_of(manifest, run.cell, "per_layer"):
        value = core.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def e2e_value(run, name: str) -> float:
    """An end-to-end metric's value: the quantity its name states up to the
    first dot (``train_img_s.vit`` is ``train_img_s``, held in the cells of
    one model family under a bound of its own)."""
    if name == "setup_s":
        return run.setup_s
    return run.metrics[name] if name in run.metrics else run.metrics[name.split(".")[0]]


def result_line(manifest: dict, run, kind: str, power_w) -> dict:
    """The result's JSON object; ``kind`` names the card."""
    if run.trace:
        metrics = per_layer(manifest, run)
    else:
        metrics = {}
        for m in core.metrics_of(manifest, run.cell, "end_to_end"):
            metrics[m["name"]] = {"value": e2e_value(run, m["name"]), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind,
              "count": run.workload["chips"], "memory_peak_bytes": int(run.memory_peak_bytes),
              "power_limit_w": power_w}
    out = {"correct": all(c.ok for c in run.checks) and run.failed == 0 and bool(run.checks),
           "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
           "device": device}
    if run.trace and run.tracer is not None:
        device["busy_s"] = run.tracer.busy_s
        device["window_s"] = run.tracer.window_s
        out["breakdown"] = {"device_ops": run.tracer.device_ops,
                            "idle_gaps": run.tracer.idle_gaps}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    manifest = core.load_manifest()
    entry, workload, config = load_cell(manifest, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"[bench] needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = core.Run(cell=args.workload, workload=workload, config=config, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace))
    power_w = core.power_limit_w()
    core.traffic_driver(workload["kind"]).run(run)
    found = core.forbidden_loaded()
    if found:
        print(f"[bench] modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    line = result_line(manifest, run, torch.cuda.get_device_name(0), power_w)
    for c in run.checks:
        print(f"[check] {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.stderr.flush()
    sys.stdout.flush()
    # threads of the program (decode pools) must not keep
    # the process alive once the result is out
    os._exit(code)
