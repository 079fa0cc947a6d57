"""Device resolution for the port's entry points.

Entry points take ``--device`` with default ``cuda``. A missing GPU is an
error unless the caller asked for the CPU explicitly: nothing carries on on
the CPU by itself.

The f32 paths (the cosine distance matrix, the f32 gallery search's plain
version, f32 extraction) run in full float32: TF32 is switched off for both
matrix products and cuDNN convolutions when a CUDA device is resolved.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """→ the ``torch.device`` for ``name``; raises if it names CUDA and no
    GPU is present."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass --device cpu (device='cpu') "
                "to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use cuda[:N] or cpu")
    return dev


def add_device_flag(parser) -> None:
    """The ``--device`` flag every entry point of the port takes."""
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="cuda (default; an error when no GPU is present) or cpu",
    )


def parse_dtype(name: str) -> torch.dtype:
    """``--compute_dtype`` value → torch dtype (float32 or bfloat16)."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"--compute_dtype must be one of {sorted(dtypes)}, got {name!r}")
    return dtypes[name]
