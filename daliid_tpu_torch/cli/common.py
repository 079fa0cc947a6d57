"""Shared CLI plumbing of the port: the multi-split refusal and the SIE
camera-id check."""

from __future__ import annotations


def refuse_multisplit(target: str, splits: dict, command: str) -> None:
    """Exit with an error that names ``target`` when its query or gallery
    is a list of splits (PRCC, VC-Clothes, ImageNet): only ``evaluate``
    ranks such a protocol, split by split; ``command`` would hand the list
    to the extractor as if it were one table."""
    if isinstance(splits["query"], list) or isinstance(splits["gallery"], list):
        raise SystemExit(f"{target} is a multi-split protocol (lists of query sets and "
                         f"gallery splits), which {command} does not rank; evaluate it with "
                         f"`evaluate --targets {target}`")


def check_camera_ids(sie_cameras: int, tables, what: str) -> None:
    """Raw camids index the SIE table: refuse a table too small for them
    (an out-of-range index would stop the GPU with a device assert).
    ``tables`` holds tables or lists of them (a multi-split protocol's)."""
    flat = [t for x in tables for t in (x if isinstance(x, list) else [x])]
    cam_max = max((int(t.camids.max()) for t in flat if len(t.camids)), default=0)
    if cam_max >= sie_cameras:
        raise SystemExit(f"--sie_cameras {sie_cameras} is too small for {what}: camids run up "
                         f"to {cam_max} and index the table directly (1-based datasets need "
                         f"max+1 = {cam_max + 1})")
