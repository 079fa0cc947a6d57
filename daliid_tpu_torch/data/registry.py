"""Dataset registry: parsers producing (path, pid, camid, kind) tables.

Port of ``daliid_tpu/data/registry.py`` for the serving, evaluation and
training paths: :class:`ReidTable` (``registry.py:27-100``),
:func:`parse_market_duke_dir` (``:107-120``), :func:`data_root` (``:199``),
:func:`load_dataset` (``:387``) with the ``Market`` and ``Synthetic``
datasets and their ``train`` splits, and :func:`merge_train_tables`
(``:400``). The Synthetic set's turbulence copies are under
``<root>/Synthetic/turbulence``. The other formats (MSMT17, VeRi,
DeepChange, PRCC, BRIAR manifests, ...) are not ported yet. Roots come from
``root=`` or ``DALIID_DATA_ROOT``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Sequence

import numpy as np


@dataclasses.dataclass
class ReidTable:
    """A re-ID image table: one row per image (numpy struct of arrays)."""

    paths: np.ndarray      # (N,) object/str
    pids: np.ndarray       # (N,) int64
    camids: np.ndarray     # (N,) int64
    kinds: np.ndarray      # (N,) object/str, 'person' | 'object'
    name: str = ""

    def __post_init__(self):
        self.paths = np.asarray(self.paths, dtype=object)
        self.pids = np.asarray(self.pids, dtype=np.int64)
        self.camids = np.asarray(self.camids, dtype=np.int64)
        self.kinds = np.asarray(self.kinds, dtype=object)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx) -> "ReidTable":
        return ReidTable(self.paths[idx], self.pids[idx], self.camids[idx], self.kinds[idx], self.name)

    @property
    def num_ids(self) -> int:
        return len(np.unique(self.pids))

    @property
    def num_cams(self) -> int:
        return len(np.unique(self.camids))

    def concat(self, other: "ReidTable") -> "ReidTable":
        return ReidTable(
            np.concatenate([self.paths, other.paths]),
            np.concatenate([self.pids, other.pids]),
            np.concatenate([self.camids, other.camids]),
            np.concatenate([self.kinds, other.kinds]),
            self.name,
        )

    def relabeled(self, offset: int = 0) -> "ReidTable":
        """Densely renumber pids to 0..C-1 (+offset)."""
        _, inv = np.unique(self.pids, return_inverse=True)
        return ReidTable(self.paths, inv + offset, self.camids, self.kinds, self.name)

    def as_legacy_array(self) -> np.ndarray:
        """Reference-compatible ``[path, pid, camid, kind]`` string matrix."""
        return np.stack(
            [
                self.paths.astype(str),
                self.pids.astype(str),
                self.camids.astype(str),
                self.kinds.astype(str),
            ],
            axis=1,
        )

    @staticmethod
    def from_rows(rows: Sequence[Sequence], name: str = "") -> "ReidTable":
        if len(rows) == 0:
            return ReidTable(np.array([]), np.array([]), np.array([]), np.array([]), name)
        paths, pids, camids, kinds = zip(*rows)
        return ReidTable(
            np.array(paths, dtype=object),
            np.array([int(p) for p in pids]),
            np.array([int(c) for c in camids]),
            np.array(kinds, dtype=object),
            name,
        )


def parse_market_duke_dir(directory: str, kind: str = "person") -> ReidTable:
    """Market-1501/Duke filename scheme ``<pid>_c<cam>...jpg``; junk pid -1
    rows are dropped."""
    rows = []
    for filename in sorted(os.listdir(directory)):
        if not filename.endswith(".jpg"):
            continue
        parts = filename.split("_")
        pid = int(parts[0])
        if pid == -1:
            continue
        camid = int(parts[1][1])
        rows.append((os.path.join(directory, filename), pid, camid, kind))
    return ReidTable.from_rows(rows)


def data_root(root: str | None = None) -> str:
    return root or os.environ.get("DALIID_DATA_ROOT", "/data/reid")


_LOADERS: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(fn):
        _LOADERS[name] = fn
        return fn

    return deco


@register_dataset("Market")
def _load_market(root):
    base = os.path.join(root, "Market-1501-v15.09.15")
    return {
        "train": parse_market_duke_dir(os.path.join(base, "bounding_box_train")),
        "gallery": parse_market_duke_dir(os.path.join(base, "bounding_box_test")),
        "query": parse_market_duke_dir(os.path.join(base, "query")),
    }


@register_dataset("Synthetic")
def _load_synthetic(root):
    """Deterministic generated dataset, built on first use under
    ``<root>/Synthetic`` with the same generator settings (and so the same
    files) as the JAX package. Generation holds an exclusive flock so two
    processes on one host do not race."""
    import fcntl

    from daliid_tpu_torch.data.synthetic import make_synthetic_dataset

    base = os.path.join(root, "Synthetic")
    marker = os.path.join(base, "bounding_box_train")
    if not os.path.isdir(marker):
        os.makedirs(root, exist_ok=True)
        with open(base + ".lock", "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                if not os.path.isdir(marker):
                    make_synthetic_dataset(
                        base, num_ids=16, imgs_per_id_train=8, imgs_per_id_test=4
                    )
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)
    return {
        "train": parse_market_duke_dir(os.path.join(base, "bounding_box_train")),
        "gallery": parse_market_duke_dir(os.path.join(base, "bounding_box_test")),
        "query": parse_market_duke_dir(os.path.join(base, "query")),
    }


def load_dataset(name: str, root: str | None = None) -> Dict[str, ReidTable]:
    """Load a registered dataset → dict with 'train'/'gallery'/'query'."""
    if name not in _LOADERS:
        raise KeyError(f"unknown or not yet ported dataset {name!r}; "
                       f"registered: {sorted(_LOADERS)}")
    splits = _LOADERS[name](data_root(root))
    for v in splits.values():
        if isinstance(v, ReidTable):
            v.name = name
    return splits


def merge_train_tables(tables: Sequence[ReidTable]) -> ReidTable:
    """Concatenate training tables with densely renumbered, offset classes —
    the reference's multi-target class offsetting (``evaluate.py:131-174``)."""
    merged = None
    offset = 0
    for t in tables:
        r = t.relabeled(offset=offset)
        offset += r.num_ids
        merged = r if merged is None else merged.concat(r)
    return merged
