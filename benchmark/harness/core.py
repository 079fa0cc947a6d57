"""The harness: finding a cell's files, the run's record, and its result line.

Everything that belongs to one cell, configuration, traffic kind or
per-layer metric is a file of its own, found by name:

- ``benchmark/workloads/<cell>.json``: its configuration, traffic mix and
  kind, chips, why, the kind's parameters and the limits of ``correct``;
- ``benchmark/configs/<config>.json``: the model, its source and widths,
  how the program builds it and the path of its reference module
  (:mod:`benchmark.harness.models`);
- ``benchmark/traffic/<kind>.py``: the driver of a traffic kind, with
  ``run(run) -> None``;
- ``benchmark/layer_metrics/<metric>.py``: a reader with
  ``read(run) -> float | None``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"
# top-level modules that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "daliid_tpu")


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    with open(path) as f:
        return json.load(f)


def traffic_driver(kind: str):
    return importlib.import_module(f"benchmark.traffic.{kind}")


def metric_reader(name: str):
    path = BENCH / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_layer_metric_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader {path.relative_to(ROOT)}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(manifest: dict, cell: str, section: str) -> list:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those that list it, and those without a list that
    hold for every cell (end-to-end) or for every cell that reports the
    metric they move (per-layer)."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def forbidden_loaded() -> list:
    """Modules in ``sys.modules`` whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def process_start_time() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def power_limit_w():
    """The card's power limit in watts from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


@dataclass
class Check:
    """One compared number: ``value`` must not exceed ``limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Run:
    """What a traffic driver is handed and fills in."""

    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    cache: Path = ROOT / "build" / "benchmark"
    t_start: float = field(default_factory=process_start_time)
    # filled by the driver
    window_s: float = 0.0
    setup_s: float = 0.0
    metrics: dict = field(default_factory=dict)      # end-to-end values
    spans: dict = field(default_factory=dict)        # seconds inside the window
    counts: dict = field(default_factory=dict)       # work done inside the window
    shapes: dict = field(default_factory=dict)       # what the rooflines count
    checks: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    tracer: object = None                            # tracing.Trace of the window
    # the timed path's faults for the benchmark's own tests
    fault: str | None = None
    # the control in the program's place where the check can only follow
    # the program's own state (``benchmark/control.py``)
    control: bool = False

    @property
    def params(self) -> dict:
        return self.workload["params"]

    def limit(self, name: str) -> float:
        return float(self.workload["limits"][name])

    def check(self, name: str, value: float) -> None:
        """Hold ``value`` to the cell's limit; a number the cell sets no
        limit for is printed and not compared."""
        if name not in self.workload["limits"]:
            self.note(f"{name} {float(value)!r} (not compared in this cell)")
            return
        self.checks.append(Check(name, float(value), self.limit(name)))

    def mark(self, what: str) -> None:
        """Note the seconds since the process started, after ``what``."""
        self.note(f"{time.time() - self.t_start:.2f} s: {what}")

    def note(self, msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)
