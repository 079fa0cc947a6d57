"""BRIAR-style ``.npy`` manifest ingest with probe filtering.

Port of ``daliid_tpu/data/briar.py``: :func:`load_briar_manifests`
(``:58``) and :func:`load_eval_splits` (``:94``), the reference's BRIAR
path (``Person-ReID/evaluate.py:77-128``):

- train/query/gallery manifests are ``.npy`` object arrays of rows
  ``[path, id_name, camid, distance_tag, ...]`` whose identity names carry a
  one-character prefix, stripped here;
- probes whose distance tag contains ``"range"`` (close-range capture) are
  dropped;
- probe identities absent from the gallery are dropped;
- query and gallery share ONE dense id map and ONE dense camid map over the
  union of both splits (the reference compares the raw strings across
  splits), so splits whose camera strings are disjoint never share an
  index; train ids are densely renumbered on their own.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from daliid_tpu_torch.data.registry import ReidTable, load_dataset


def _strip_id_prefix(ids: np.ndarray) -> np.ndarray:
    return np.array([str(i)[1:] for i in ids])


def _to_table(rows: np.ndarray, kind: str = "person") -> ReidTable:
    """Rows → a table with ids and camera strings densely renumbered."""
    _, pids = np.unique(rows[:, 1], return_inverse=True)
    _, camids = np.unique(rows[:, 2], return_inverse=True)
    return ReidTable(paths=rows[:, 0], pids=pids.astype(np.int64),
                     camids=camids.astype(np.int64),
                     kinds=np.array([kind] * len(rows), dtype=object), name="BRIAR")


def _shared_dense_map(*label_columns: np.ndarray) -> dict:
    """One dense int mapping over the union of the label columns."""
    uniq = np.unique(np.concatenate([np.asarray(c, object) for c in label_columns]))
    return {v: i for i, v in enumerate(uniq)}


def load_briar_manifests(train_npy: str, queries_npy: str, gallery_npy: str
                         ) -> Tuple[ReidTable, ReidTable, ReidTable]:
    """→ (train, query, gallery) tables with the reference's filtering."""
    train, queries, gallery = (np.load(p, allow_pickle=True).astype(object)
                               for p in (train_npy, queries_npy, gallery_npy))
    for arr in (train, queries, gallery):
        arr[:, 1] = _strip_id_prefix(arr[:, 1])
    queries = queries[np.array(["range" not in str(tag) for tag in queries[:, 3]], bool)]
    probe_only = np.setdiff1d(queries[:, 1], gallery[:, 1])
    queries = queries[~np.isin(queries[:, 1], probe_only)]

    id_map = _shared_dense_map(queries[:, 1], gallery[:, 1])
    cam_map = _shared_dense_map(queries[:, 2], gallery[:, 2])

    def shared(rows):
        t = _to_table(rows)
        t.pids = np.array([id_map[i] for i in rows[:, 1]], np.int64)
        t.camids = np.array([cam_map[c] for c in rows[:, 2]], np.int64)
        return t

    return _to_table(train), shared(queries), shared(gallery)


def load_eval_splits(dataset: str, root: str | None = None, train_npy: str | None = None,
                     queries_npy: str | None = None, gallery_npy: str | None = None):
    """The evaluation CLIs' ingest: a registered dataset name, or
    ``"BRIAR"`` with the three manifest paths (ranked with the standard
    protocol by the callers) → ``{train, query, gallery}`` splits."""
    paths = (train_npy, queries_npy, gallery_npy)
    if any(paths) and not all(paths):
        raise SystemExit("--train_file_path/--queries_file_path/--gallery_file_path "
                         "must be given together (evaluate.py:77)")
    if dataset == "BRIAR":
        if not all(paths):
            raise SystemExit("the BRIAR dataset requires --train_file_path, "
                             "--queries_file_path and --gallery_file_path "
                             "(evaluate.py:77-128)")
        train, query, gallery = load_briar_manifests(*paths)
        return {"train": train, "query": query, "gallery": gallery}
    if any(paths):
        raise SystemExit("manifest paths are consumed by the BRIAR dataset only "
                         "(evaluate.py:130-136)")
    return load_dataset(dataset, root=root)
