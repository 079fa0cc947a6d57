"""Shared CLI plumbing of the port: flags of features not yet ported, and
the SIE camera-id check."""

from __future__ import annotations


def reject_unported(args, defaults: dict) -> None:
    """Exit with a clear error for any flag in ``defaults`` that the caller
    set away from its default: the feature behind it is not ported yet."""
    for name, default in defaults.items():
        if getattr(args, name, default) != default:
            raise SystemExit(f"--{name} is not yet ported to daliid_tpu_torch")


MULTIHOST_FLAGS = {"multihost": False, "coordinator_address": None,
                   "num_processes": None, "process_id": None}


def add_multihost_flags(parser) -> None:
    """The JAX CLIs' multi-host bootstrap flags, kept so that a command
    line names them; the multi-host path is not ported yet."""
    parser.add_argument("--multihost", action="store_true", help="not yet ported")
    parser.add_argument("--coordinator_address", type=str, default=None, help="not yet ported")
    parser.add_argument("--num_processes", type=int, default=None, help="not yet ported")
    parser.add_argument("--process_id", type=int, default=None, help="not yet ported")


def check_camera_ids(sie_cameras: int, tables, what: str) -> None:
    """Raw camids index the SIE table: refuse a table too small for them
    (an out-of-range index would stop the GPU with a device assert)."""
    cam_max = max((int(t.camids.max()) for t in tables if len(t.camids)), default=0)
    if cam_max >= sie_cameras:
        raise SystemExit(f"--sie_cameras {sie_cameras} is too small for {what}: camids run up "
                         f"to {cam_max} and index the table directly (1-based datasets need "
                         f"max+1 = {cam_max + 1})")
