"""Shared CLI plumbing of the port: flags of features not yet ported."""

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
