"""Dataset registry: parsers producing (path, pid, camid, kind) tables.

Port of ``daliid_tpu/data/registry.py``: :class:`ReidTable`
(``registry.py:27-100``), the per-format parsers (``:107-200``),
:func:`load_text_dataset` (``:203``), the registered loaders (``:228-384``:
Market, Duke, MSMT17 with its ``val`` split, Veri, Veri-Wild, DeepChange,
PRCC with 10 gallery splits and the query sets B, C and B+C, VC-Clothes
with Real28, Celeb-ReID, ImageNet and Synthetic), :func:`load_dataset`
(``:387``), :func:`merge_train_tables` (``:400``),
:func:`load_multiple_datasets` (``:412``) and :func:`dataset_statistics`
(``:418``). A multi-split protocol gives lists of tables for ``gallery``
and/or ``query``. The Synthetic set's turbulence copies are under
``<root>/Synthetic/turbulence``. Roots come from ``root=`` or
``DALIID_DATA_ROOT``. The BRIAR ``.npy`` manifests are read by
:mod:`daliid_tpu_torch.data.briar`.

``dataset_statistics`` formats its table itself (:func:`simple_table`):
the JAX package uses the ``tabulate`` package, which the port does not
need.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Sequence

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


def parse_veri_dir(directory: str) -> ReidTable:
    """VeRi filename scheme ``<pid>_c<cam>...jpg`` with multi-digit cam;
    rows are 'object' instances."""
    rows = []
    for filename in sorted(os.listdir(directory)):
        if not filename.endswith(".jpg"):
            continue
        parts = filename.split("_")
        pid = int(parts[0])
        if pid == -1:
            continue
        camid = int(parts[1][1:])
        rows.append((os.path.join(directory, filename), pid, camid, "object"))
    return ReidTable.from_rows(rows)


def parse_veri_wild_list(list_path: str, image_root: str) -> ReidTable:
    """VeRi-Wild manifest: ``<pid>/<img> <refid> <camid>`` per line."""
    rows = []
    with open(list_path) as f:
        for line in f:
            if not line.strip():
                continue
            subpath, _refid, camid = line.split()
            pid = int(subpath.split("/")[0])
            rows.append((os.path.join(image_root, subpath), pid, int(camid), "object"))
    return ReidTable.from_rows(rows)


def parse_msmt17_list(list_path: str, image_root: str) -> ReidTable:
    """MSMT17 list file: ``<relpath> <pid>`` per line; camid parsed from the
    filename's third ``_`` field."""
    rows = []
    with open(list_path) as f:
        for line in f:
            if not line.strip():
                continue
            img_name, pid_name = line.split()
            camid = int(img_name.split("_")[2])
            rows.append((os.path.join(image_root, img_name), int(pid_name), camid, "person"))
    return ReidTable.from_rows(rows)


def parse_deepchange_list(base_dir: str, list_file: str, split_dir: str) -> ReidTable:
    """DeepChange bbox list: ``<img>,<tracklet>`` per line, filename scheme
    ``P<pid>_C<cam>_<day>_<hour>_..``. The matching key (camid) is the
    tracklet id, as the reference ultimately returns."""
    rows = []
    with open(os.path.join(base_dir, list_file)) as f:
        for line in f:
            if not line.strip():
                continue
            img_name, tracklet_id = line.strip().split(",")
            pid = int(img_name.split("_")[0][1:])
            rows.append((os.path.join(base_dir, split_dir, img_name), pid, int(tracklet_id),
                         "person"))
    return ReidTable.from_rows(rows)


def parse_manifest(list_path: str) -> ReidTable:
    """Generic manifest: ``<path> <pid> <camid> <kind>`` per line."""
    rows = []
    with open(list_path) as f:
        for line in f:
            if not line.strip():
                continue
            path, pid, camid, kind = line.split()
            rows.append((path, int(pid), int(camid), kind))
    return ReidTable.from_rows(rows)


def data_root(root: str | None = None) -> str:
    return root or os.environ.get("DALIID_DATA_ROOT", "/data/reid")


def load_text_dataset(base_dir: str, list_dir: str = "."):
    """Author-identification text splits: ``{training,query,gallery}_tweets.txt``
    manifests of ``<author_id> <tweet_id>`` lines → object arrays of
    ``[tweets.json path, author_id, tweet_id]`` rows, returned as
    ``(train, gallery, query)``."""
    out = []
    for split in ("training", "query", "gallery"):
        rows = []
        with open(os.path.join(list_dir, f"{split}_tweets.txt")) as f:
            for line in f:
                if not line.strip():
                    continue
                author_id, tweet_id = line.split()
                rows.append([os.path.join(base_dir, author_id, "tweets.json"), author_id,
                             tweet_id])
        out.append(np.array(rows, dtype=object))
    train, query, gallery = out
    return train, gallery, query


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


@register_dataset("Duke")
def _load_duke(root):
    base = os.path.join(root, "DukeMTMC-reID")
    return {
        "train": parse_market_duke_dir(os.path.join(base, "bounding_box_train")),
        "gallery": parse_market_duke_dir(os.path.join(base, "bounding_box_test")),
        "query": parse_market_duke_dir(os.path.join(base, "query")),
    }


@register_dataset("MSMT17")
def _load_msmt17(root):
    base = os.path.join(root, "MSMT17_V2")
    train_root = os.path.join(base, "mask_train_v2")
    test_root = os.path.join(base, "mask_test_v2")
    return {
        "train": parse_msmt17_list(os.path.join(base, "list_train.txt"), train_root),
        "val": parse_msmt17_list(os.path.join(base, "list_val.txt"), train_root),
        "gallery": parse_msmt17_list(os.path.join(base, "list_gallery.txt"), test_root),
        "query": parse_msmt17_list(os.path.join(base, "list_query.txt"), test_root),
    }


@register_dataset("Veri")
def _load_veri(root):
    base = os.path.join(root, "VeRi")
    return {
        "train": parse_veri_dir(os.path.join(base, "image_train")),
        "gallery": parse_veri_dir(os.path.join(base, "image_test")),
        "query": parse_veri_dir(os.path.join(base, "image_query")),
    }


@register_dataset("Veri-Wild")
def _load_veri_wild(root):
    base = os.path.join(root, "VeRI-Wild")
    images = os.path.join(base, "images")
    split = os.path.join(base, "train_test_split")
    return {
        "train": parse_veri_wild_list(os.path.join(split, "train_list_start0.txt"), images),
        "gallery": parse_veri_wild_list(os.path.join(split, "test_10000_id.txt"), images),
        "query": parse_veri_wild_list(os.path.join(split, "test_10000_id_query.txt"), images),
    }


@register_dataset("DeepChange")
def _load_deepchange(root):
    base = os.path.join(root, "DeepChange")
    return {
        "train": parse_deepchange_list(base, "train-set-bbox.txt", "train-set"),
        "gallery": parse_deepchange_list(base, "test-set-gallery-bbox.txt", "test-set-gallery"),
        "query": parse_deepchange_list(base, "test-set-query-bbox.txt", "test-set-query"),
    }


@register_dataset("PRCC")
def _load_prcc(root):
    base = os.path.join(root, "prcc", "rgb")
    galleries = [parse_manifest(os.path.join(base, "test", f"gallery_{i}.txt"))
                 for i in range(1, 11)]
    q_b = parse_manifest(os.path.join(base, "test", "query_B.txt"))
    q_c = parse_manifest(os.path.join(base, "test", "query_C.txt"))
    return {
        "train": parse_manifest(os.path.join(base, "train.txt")),
        "val": parse_manifest(os.path.join(base, "val.txt")),
        "gallery": galleries,
        "query": [q_b, q_c, q_b.concat(q_c)],
    }


@register_dataset("VC-Clothes")
def _load_vc_clothes(root):
    vc = os.path.join(root, "ClothesChanging", "VC-Clothes")
    real = os.path.join(root, "ClothesChanging", "Real28")
    return {
        "train": parse_manifest(os.path.join(vc, "train_file.txt")),
        "gallery": [parse_manifest(os.path.join(vc, "gallery_file.txt")),
                    parse_manifest(os.path.join(real, "gallery_file.txt"))],
        "query": [parse_manifest(os.path.join(vc, "query_file.txt")),
                  parse_manifest(os.path.join(real, "query_file.txt"))],
    }


@register_dataset("Celeb-ReID")
def _load_celeb(root):
    base = os.path.join(root, "Celeb-reID", "Celeb-reID")
    return {
        "train": parse_manifest(os.path.join(base, "train_file.txt")),
        "gallery": parse_manifest(os.path.join(base, "gallery_file.txt")),
        "query": parse_manifest(os.path.join(base, "query_file.txt")),
    }


@register_dataset("ImageNet")
def _load_imagenet(root):
    base = os.path.join(root, "ImageNet")
    return {
        "train": parse_manifest(os.path.join(base, "train_file.txt")),
        "val": parse_manifest(os.path.join(base, "val_file.txt")),
        "gallery": [parse_manifest(os.path.join(base, f"gallery_file{i}.txt"))
                    for i in range(1, 11)],
        "query": [parse_manifest(os.path.join(base, f"query_file{i}.txt"))
                  for i in range(1, 11)],
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
    """Load a registered dataset → dict with 'train'/'gallery'/'query'
    (+'val' where the format defines one)."""
    if name not in _LOADERS:
        raise KeyError(f"unknown dataset {name!r}; registered: {sorted(_LOADERS)}")
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


def load_multiple_datasets(names: Sequence[str], root: str | None = None):
    """Per-target splits, training tables kept separate for the caller to
    merge."""
    return [load_dataset(n, root) for n in names]


STATS_HEADERS = ["Dataset", "#Train", "#TrainIDs", "#TrainCams", "#Gallery", "#GalIDs",
                 "#GalCams", "#Query", "#QIDs", "#QCams"]


def dataset_statistics(names: Sequence[str], root: str | None = None) -> str:
    """Per-split sample / identity / camera counts as a table: one row per
    single-split target; one row per gallery split (``<name>:g<i>``) and per
    query set (``<name>:q<i>``) of a multi-split one, ``-`` in the other
    split's columns. The same string as the JAX function's ``tabulate``."""
    rows: List[list] = []
    for name, splits in zip(names, load_multiple_datasets(names, root)):
        def stats(t):
            return [len(t), t.num_ids, t.num_cams]

        train_stats = stats(splits["train"])
        gallery, query = splits["gallery"], splits["query"]
        if isinstance(gallery, list) or isinstance(query, list):
            for gi, g in enumerate(gallery if isinstance(gallery, list) else [gallery]):
                rows.append([f"{name}:g{gi}"] + train_stats + stats(g) + ["-", "-", "-"])
            for qi, q in enumerate(query if isinstance(query, list) else [query]):
                rows.append([f"{name}:q{qi}"] + train_stats + ["-", "-", "-"] + stats(q))
        else:
            rows.append([name] + train_stats + stats(gallery) + stats(query))
    return simple_table(rows, STATS_HEADERS)


def simple_table(rows: Sequence[Sequence], headers: Sequence[str]) -> str:
    """``tabulate(rows, headers=headers)`` in its default "simple" format,
    for cells that are ints or strings which do not read as numbers: a
    column of ints only is right-aligned (header too), any other column
    left-aligned; each column as wide as its widest cell and at least its
    header plus 2; columns joined by two spaces, a line of dashes under the
    header, trailing blanks stripped from every line."""
    cols = list(zip(*rows)) if rows else [()] * len(headers)
    numeric = [bool(c) and all(isinstance(v, (int, np.integer)) and not isinstance(v, bool)
                               for v in c) for c in cols]
    cells = [[str(v) for v in c] for c in cols]
    widths = [max([len(h) + 2] + [len(v) for v in c]) for h, c in zip(headers, cells)]

    def line(values):
        return "  ".join(v.rjust(w) if num else v.ljust(w)
                         for v, w, num in zip(values, widths, numeric)).rstrip()

    out = [line(headers), "  ".join("-" * w for w in widths)]
    out += [line(r) for r in zip(*cells)]
    return "\n".join(out)
