"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level module names, and the reference loads nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.harness.core import FORBIDDEN

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _modules(sub: str) -> list:
    return [f"benchmark.{sub}.{p.stem}" for p in sorted((BENCH / sub).glob("*.py"))
            if p.stem != "__init__"]


def _loaded_top_levels(imports: list) -> set:
    code = ("import sys; sys.path.insert(0, %r)\n" % str(ROOT)
            + "".join(f"import {m}\n" for m in imports)
            + "import importlib.util as u\n"
            + "for p in sorted(__import__('pathlib').Path(%r).glob('*.py')):\n" % str(
                BENCH / "layer_metrics")
            + "    s = u.spec_from_file_location('m_' + p.stem.replace('.', '_'), p)\n"
            + "    s.loader.exec_module(u.module_from_spec(s))\n"
            + "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    return set(out.split())


def test_the_harness_loads_no_jax_and_no_jax_package():
    mods = (["benchmark.run", "benchmark.control"]
            + _modules("harness") + _modules("traffic") + _modules("reference")
            + _modules("roofline"))
    loaded = _loaded_top_levels(mods)
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_program_loads_no_jax_package():
    # the drivers import the program inside their functions; import it whole
    loaded = _loaded_top_levels(["daliid_tpu_torch.train.trainer",
                                 "daliid_tpu_torch.eval.features",
                                 "daliid_tpu_torch.models.transreid_jpm",
                                 "daliid_tpu_torch.metrics.ranking"])
    assert "daliid_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_top_levels(_modules("reference"))
    assert "daliid_tpu_torch" not in loaded and not loaded & set(FORBIDDEN)
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("daliid_tpu_torch", *FORBIDDEN), (path, n)


def test_forbidden_names_compare_whole_top_levels(monkeypatch):
    from benchmark.harness import core

    monkeypatch.setitem(sys.modules, "daliid_tpu_torch_lookalike", object())
    assert "daliid_tpu" not in core.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "daliid_tpu.models", object())
    assert "daliid_tpu" in core.forbidden_loaded()
