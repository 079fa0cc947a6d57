"""The PyTorch port stands alone and runs on the GPU unless told otherwise.

- importing ``daliid_tpu_torch`` and every submodule in a fresh interpreter
  loads no ``jax`` / ``flax`` module and nothing of the JAX package
  ``daliid_tpu`` (``daliid_tpu_torch`` itself is not a ``daliid_tpu.*``
  module);
- no source file of the port imports either;
- an entry point started without ``--device`` on a host without CUDA exits
  with an error instead of running on the CPU;
- every public top-level name of a ``daliid_tpu`` module has a port of the
  same name at the same path, or a row in the README's counterpart map.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "daliid_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import daliid_tpu_torch
names = [m.name for m in pkgutil.walk_packages(daliid_tpu_torch.__path__, "daliid_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "daliid_tpu"))
print(len(names), "modules;", "foreign:", bad)
sys.exit(1 if bad else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_import_loads_no_jax_and_nothing_of_daliid_tpu():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20, r.stdout  # every subpackage was walked


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|flax|daliid_tpu)\b(?!_)"
                        r"|from\s+(jax|flax|daliid_tpu)(\.|\s))", re.M)


def test_sources_import_no_jax_and_nothing_of_daliid_tpu():
    files = sorted(PORT.rglob("*.py"))
    assert files
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits
    # the pattern itself: the port's own imports pass, the JAX package's do not
    assert not _FORBIDDEN.search("from daliid_tpu_torch.ops import _build")
    assert not _FORBIDDEN.search("import daliid_tpu_torch")
    assert _FORBIDDEN.search("from daliid_tpu.eval import matcher")
    assert _FORBIDDEN.search("import daliid_tpu")
    assert _FORBIDDEN.search("from jax import numpy")


@pytest.mark.parametrize("argv", [
    ["-m", "daliid_tpu_torch.cli.search", "--dataset", "Synthetic"],
    ["-m", "daliid_tpu_torch.cli.evaluate", "--targets", "Synthetic"],
    ["-m", "daliid_tpu_torch", "serve", "--port", "0"],
    ["-m", "daliid_tpu_torch", "train", "--dataset", "Synthetic"],
    ["-m", "daliid_tpu_torch", "evaluate-fusion", "--dataset", "Synthetic"],
    ["-m", "daliid_tpu_torch", "evaluate-ensemble", "--dataset", "Synthetic"],
    ["-m", "daliid_tpu_torch", "export", "--model_name", "resnet50", "--input", "in.pt",
     "--output", "out.npz"],
])
def test_entry_point_without_device_refuses_a_host_without_cuda(tmp_path, argv):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid here")
    takes_data = "serve" not in argv and "export" not in argv
    r = subprocess.run([sys.executable, *argv, "--data_root", str(tmp_path)]
                       if takes_data else [sys.executable, *argv],
                       cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr, r.stderr
    assert not (tmp_path / "Synthetic").exists()  # it stopped before any work


def test_kernel_build_is_keyed_by_the_sources_and_needs_nvcc(tmp_path, monkeypatch):
    from daliid_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text("// one\n")
    first = _build._library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    second = _build._library_path("k")
    (tmp_path / "shared.cuh").write_text("// header\n")  # headers are part of the key
    assert len({first, second, _build._library_path("k")}) == 3
    if _build.shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("k")
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


def test_kernels_build_in_the_checkout_or_a_user_cache(tmp_path, monkeypatch):
    """A checkout builds under its own ``build/``; an installed copy, which
    has no repository root, under the per-user cache."""
    from daliid_tpu_torch.ops import _build

    assert _build.BUILD_DIR == REPO / "build" / "daliid_tpu_torch"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    installed = tmp_path / "site-packages" / "daliid_tpu_torch"
    assert _build.build_dir(installed) == tmp_path / "cache" / "daliid_tpu_torch"


def _public_names(path: Path) -> set:
    """Top-level public functions, classes and assignments of a module, and
    the names a package's ``__init__`` imports."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_every_jax_name_has_a_port_or_a_row_in_the_readme_map():
    readme = (REPO / "README.md").read_text()
    section = readme.split("### What has no port of the same name", 1)[1].split("\n## ", 1)[0]
    mapped = set(re.findall(r"`([A-Za-z_][\w./]*)`", section))
    jax_pkg = REPO / "daliid_tpu"
    unmapped = []
    for src in sorted(jax_pkg.rglob("*.py")):
        port = PORT / src.relative_to(jax_pkg)
        missing = _public_names(src) - (_public_names(port) if port.exists() else set())
        unmapped += [f"{src.relative_to(REPO)}: {n}" for n in sorted(missing - mapped)]
    for src in sorted(jax_pkg.rglob("*.cpp")):
        if not (PORT / src.relative_to(jax_pkg)).exists() and \
                str(src.relative_to(jax_pkg)) not in mapped:
            unmapped.append(str(src.relative_to(REPO)))
    assert not unmapped, unmapped
