"""ctypes wrapper for the native C++ JPEG loader (decode + bicubic resize).

The port's own copy of ``daliid_tpu/data/native_loader.py`` and its
``cpp/loader.cpp``: libjpeg decode and a Keys-bicubic resample on a
``std::thread`` pool, filling one preallocated uint8 (N, H, W, 3) buffer
with no Python in the loop. It matches PIL's bicubic decode to about 1/255
and exactly where no resize happens.

``g++ -O3 -march=native`` builds it at first use into the port's build
directory (``ops/_build.py::BUILD_DIR``, ``build/daliid_tpu_torch/``), named
by the host's CPU flags (``-march=native`` bakes in this host's instruction
set, so another CPU builds its own) and a hash of what it is built from. It
links the system's libjpeg (``-ljpeg``) or, on a host without libjpeg's
development files, the ABI-62 libjpeg that Pillow's wheel ships
(``pillow.libs/libjpeg-*.so.62*``, the library PIL itself decodes with),
compiled against the ABI-62 headers kept in ``cpp/jpeg62/``. When neither
builds, the loader is unavailable, :func:`build_error` keeps the
compilers' messages, and the callers decode with PIL
(``augment/preprocess.py::decode_images``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np
import PIL

from daliid_tpu_torch.ops import _build

SRC = Path(__file__).resolve().parent / "cpp" / "loader.cpp"
JPEG62 = SRC.parent / "jpeg62"
_lock = threading.Lock()
_lib = None
_linked: str | None = None
_error: str | None = None


def _host_tag() -> str:
    """Hash of the host's machine type and CPU flags."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next(line for line in f if line.startswith(("flags", "Features")))
    except (OSError, StopIteration):
        flags = platform.processor() or ""
    return hashlib.sha1((platform.machine() + flags).encode()).hexdigest()[:10]


def pillow_libjpeg() -> Path | None:
    """The ABI-62 libjpeg in Pillow's wheel (``pillow.libs``), if it has one."""
    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    found = sorted(libs.glob("libjpeg-*.so.62*"))
    return found[0] if found else None


def link_variants() -> list:
    """→ [(name, g++ arguments that pick the libjpeg, build key)], in the
    order tried: the system's libjpeg, then Pillow's."""
    variants = [("system", ["-ljpeg"], b"")]
    lib = pillow_libjpeg()
    if lib is not None:
        key = str(lib).encode() + b"".join(h.read_bytes() for h in sorted(JPEG62.glob("*.h")))
        variants.append(("pillow", ["-I", str(JPEG62), str(lib), f"-Wl,-rpath,{lib.parent}"],
                         key))
    return variants


def library_path(name: str, key: bytes) -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + key).hexdigest()[:12]
    return _build.BUILD_DIR / f"libloader-{name}-{_host_tag()}-{digest}.so"


def compile_library(lib: Path, link_args: list) -> None:
    """``g++`` the loader into ``lib`` (atomically) with ``link_args``."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", "-O3", "-march=native", "-funroll-loops", "-std=c++17", "-shared", "-fPIC",
         "-o", str(tmp), str(SRC), *link_args, "-lpthread"],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exit {proc.returncode}: {proc.stderr.strip()}")
    os.replace(tmp, lib)


def _load():
    global _lib, _linked, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        errors = []
        for name, link_args, key in link_variants():
            try:
                path = library_path(name, key)
                if not path.exists():
                    compile_library(path, link_args)
                lib = ctypes.CDLL(str(path))
            except (OSError, RuntimeError) as exc:  # no g++, no libjpeg, no loadable library
                errors.append(f"{name} libjpeg: {type(exc).__name__}: {exc}")
                continue
            lib.decode_resize_batch.restype = ctypes.c_int
            lib.decode_resize_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ]
            _lib, _linked = lib, name
            return _lib
        _error = "; ".join(errors)
        return None


def native_loader_available() -> bool:
    """Whether the library is built (building it on the first call)."""
    return _load() is not None


def build_error() -> str | None:
    """Why the library is unavailable (the compilers' own messages), or None."""
    _load()
    return _error


def linked() -> str | None:
    """Which libjpeg the loaded library links ("system" or "pillow"), or None."""
    _load()
    return _linked


def decode_resize_batch(paths, height: int, width: int, num_threads: int = 16) -> np.ndarray:
    """Decode + resize JPEG ``paths`` → (N, H, W, 3) uint8. Raises
    ``FileNotFoundError`` or ``ValueError`` naming the first failing path, as
    the PIL path does."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native loader is unavailable: {_error}")
    n = len(paths)
    out = np.empty((n, height, width, 3), dtype=np.uint8)
    statuses = np.zeros(n, dtype=np.int32)
    names = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    failures = lib.decode_resize_batch(
        names, n, height, width, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max(1, int(num_threads)))
    if failures:
        bad = int(np.argmax(statuses != 0))
        if statuses[bad] == 1:
            raise FileNotFoundError(f"cannot open image: {paths[bad]}")
        raise ValueError(f"cannot decode image ({int(statuses[bad])}): {paths[bad]}")
    return out
