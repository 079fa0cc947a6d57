"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``daliid_tpu_torch/csrc/<name>.cu`` compiles on first use into its own
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/daliid_tpu_torch/lib<name>-<hash>.so

under the repository root (in an installed copy of the package, which has
no repository root, under ``$XDG_CACHE_HOME/daliid_tpu_torch``, by default
``~/.cache/daliid_tpu_torch``). ``<hash>`` is taken over the source, the shared
headers and the flags, so an edited source builds anew and an unchanged one
is loaded as it is. :func:`build_all` starts one ``nvcc`` per source at once
and waits for all of them, which is how ``chip_smoke.py`` builds.

Nothing here runs at import time: the CPU tests import every module of the
port on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def build_dir(package: Path) -> Path:
    """Where the libraries of the package at ``package`` are built:
    ``build/daliid_tpu_torch`` at the repository root in a checkout, else a
    per-user cache."""
    root = package.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "daliid_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "daliid_tpu_torch"


BUILD_DIR = build_dir(CSRC.parent)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's CUDA kernels build with the "
                           "CUDA toolkit on the machine with the GPU")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, subprocess.Popen | None]:
    """Start ``nvcc`` for one source unless its library is already built."""
    lib = _library_path(name)
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp  # type: ignore[attr-defined]
    return lib, proc


def _finish(name: str, lib: Path, proc: subprocess.Popen | None) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
    lib.with_suffix(".log").write_text(out)
    os.replace(proc.tmp, lib)  # type: ignore[attr-defined]


def build_all() -> dict[str, Path]:
    """Build every ``csrc/*.cu`` in parallel; → {name: library path}."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        started = {n: _start(n) for n in names}
        for n, (lib, proc) in started.items():
            _finish(n, lib, proc)
    return {n: lib for n, (lib, _) in started.items()}


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v`` register and shared-memory
    report) from the build of ``csrc/<name>.cu``, or '' if not built here."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _loaded:
            lib, proc = _start(name)
            _finish(name, lib, proc)
            _loaded[name] = ctypes.CDLL(str(lib))
        return _loaded[name]


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
