"""Deterministic synthetic re-ID datasets (+ turbulence companions).

Copy of ``daliid_tpu/data/synthetic.py::make_synthetic_dataset`` (``:72``)
and its image helpers: a Market-1501-shaped tree of small JPEGs where each
identity has a distinctive color/stripe signature. The same seed writes the
same files as the JAX package's generator (numpy ``default_rng`` and PIL,
step for step).

The port adds generators of the same images in the layouts its other
readers take, so that the MSMT17, PRCC and BRIAR paths run without the
datasets: :func:`make_msmt17_tree` (``MSMT17_V2`` list files, with
pid-prefixed turbulence copies), :func:`make_prcc_tree` (``prcc/rgb``
manifests: 10 gallery splits, query sets B and C) and
:func:`make_briar_manifests` (the three ``.npy`` manifests, with the
close-range probes and probe-only identities their reader drops).
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image, ImageFilter

from daliid_tpu_torch.data.registry import parse_market_duke_dir


def _identity_image(
    rng: np.random.Generator, pid: int, camid: int, h: int, w: int,
    appearance: str = "color",
) -> Image.Image:
    """An image whose appearance is mostly a function of pid, with mild
    camera- and sample-level variation (``appearance`` 'color' or
    'stripes', as in the JAX package)."""
    base_rng = np.random.default_rng(pid * 7919 + 13)
    if appearance == "stripes":
        img = np.full((h, w, 3), 112.0, dtype=np.float32)
        period = int(base_rng.integers(5, 13))
        phase = int(base_rng.integers(0, period))
        duty = int(base_rng.integers(1, period))
        rows = ((np.arange(h) + phase) % period) < duty
        img[rows] += 70.0
        vperiod = int(base_rng.integers(4, 11))
        vphase = int(base_rng.integers(0, vperiod))
        cols = ((np.arange(w) + vphase) % vperiod) < max(vperiod // 2, 1)
        img[:, cols] -= 35.0
    else:
        base_color = base_rng.integers(40, 216, size=3)
        stripe_color = base_rng.integers(40, 216, size=3)
        stripe_period = int(base_rng.integers(4, 12))
        img = np.zeros((h, w, 3), dtype=np.float32)
        img[:] = base_color
        rows = (np.arange(h) // stripe_period) % 2 == 0
        img[rows] = stripe_color
    img += (camid - 2) * 8.0
    img += rng.normal(0.0, 12.0, size=img.shape)
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))


def _turbulence_render(img: Image.Image, strength: int, rng: np.random.Generator) -> Image.Image:
    """Blur radius and additive noise grow with strength 1-5."""
    out = img.filter(ImageFilter.GaussianBlur(radius=0.6 * strength))
    arr = np.asarray(out).astype(np.float32)
    arr += rng.normal(0.0, 3.0 * strength, size=arr.shape)
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


def make_synthetic_dataset(
    root: str,
    num_ids: int = 8,
    imgs_per_id_train: int = 6,
    imgs_per_id_test: int = 4,
    num_cams: int = 3,
    height: int = 64,
    width: int = 32,
    with_turbulence: bool = True,
    seed: int = 12,
    appearance: str = "color",
    turbulence_splits: tuple = ("train",),
):
    """Build the tree and return (splits dict, turbulence_dir).

    Layout mirrors Market-1501: ``bounding_box_train``,
    ``bounding_box_test`` (gallery), ``query``, with filenames
    ``<pid>_c<cam>s1_<idx>.jpg``."""
    rng = np.random.default_rng(seed)
    dirs = {
        "train": os.path.join(root, "bounding_box_train"),
        "gallery": os.path.join(root, "bounding_box_test"),
        "query": os.path.join(root, "query"),
    }
    turb_dir = os.path.join(root, "turbulence")
    for d in list(dirs.values()) + ([turb_dir] if with_turbulence else []):
        os.makedirs(d, exist_ok=True)

    def emit(split: str, pid: int, idx: int) -> None:
        camid = int(rng.integers(1, num_cams + 1))
        name = f"{pid:04d}_c{camid}s1_{idx:06d}.jpg"
        img = _identity_image(rng, pid, camid, height, width, appearance=appearance)
        img.save(os.path.join(dirs[split], name), quality=92)
        if with_turbulence and split in turbulence_splits:
            stem = name[:-4]
            for s in range(1, 6):
                _turbulence_render(img, s, rng).save(
                    os.path.join(turb_dir, f"{stem}_turbstrength{s}.jpg"), quality=92
                )

    for pid in range(1, num_ids + 1):
        for i in range(imgs_per_id_train):
            emit("train", pid, i)
        for i in range(imgs_per_id_test):
            emit("gallery", pid, 100 + i)
        for i in range(max(1, imgs_per_id_test // 2)):
            emit("query", pid, 200 + i)

    splits = {k: parse_market_duke_dir(d) for k, d in dirs.items()}
    for t in splits.values():
        t.name = "Synthetic"
    return splits, turb_dir


def _save(img: Image.Image, path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img.save(path, quality=92)
    return path


def make_msmt17_tree(root: str, train_ids: int = 8, imgs_per_train_id: int = 4,
                     test_ids: int = 8, gallery_per_id: int = 3, query_per_id: int = 1,
                     num_cams: int = 15, height: int = 64, width: int = 32, seed: int = 12,
                     turbulence_strengths=(1, 2, 3, 4, 5)) -> str:
    """``<root>/MSMT17_V2`` as the MSMT17 loader reads it: ``list_{train,
    val,gallery,query}.txt`` of ``<pid>/<pid>_<idx>_<cam>_<time>_<n>_0.jpg
    <pid>`` lines over ``mask_train_v2`` (train and val: one more image per
    train identity) and ``mask_test_v2``, and the turbulence copies of every
    train and gallery image, named ``<pid>_<stem>_turbstrength{s}.jpg`` only
    (MSMT17's scheme), under ``MSMT17_V2/turbulence`` → that directory."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "MSMT17_V2")
    turb_dir = os.path.join(base, "turbulence")
    lists = {"train": [], "val": [], "gallery": [], "query": []}

    def emit(split: str, pid: int, idx: int, turbulence: bool) -> None:
        cam = int(rng.integers(1, num_cams + 1))
        rel = f"{pid:04d}/{pid:04d}_{idx:03d}_{cam:02d}_0303morning_{idx:04d}_0.jpg"
        sub = "mask_train_v2" if split in ("train", "val") else "mask_test_v2"
        img = _identity_image(rng, pid if sub == "mask_train_v2" else 5000 + pid, cam,
                              height, width)
        path = _save(img, os.path.join(base, sub, rel))
        lists[split].append(f"{rel} {pid}\n")
        if turbulence:
            stem = os.path.basename(path)[:-4]
            for s in turbulence_strengths:
                _save(_turbulence_render(img, s, rng),
                      os.path.join(turb_dir, f"{pid:04d}_{stem}_turbstrength{s}.jpg"))

    for pid in range(train_ids):
        for i in range(imgs_per_train_id):
            emit("train", pid, i, True)
        emit("val", pid, imgs_per_train_id, False)
    for pid in range(test_ids):
        for i in range(gallery_per_id):
            emit("gallery", pid, i, True)
        for i in range(query_per_id):
            emit("query", pid, gallery_per_id + i, False)
    for split, lines in lists.items():
        with open(os.path.join(base, f"list_{split}.txt"), "w") as f:
            f.writelines(lines)
    return turb_dir


def make_prcc_tree(root: str, train_ids: int = 6, test_ids: int = 6, imgs_per_id: int = 2,
                   height: int = 64, width: int = 32, seed: int = 12) -> None:
    """``<root>/prcc/rgb`` as the PRCC loader reads it: ``train.txt`` and
    ``val.txt``, and under ``test/`` the manifests ``gallery_{1..10}.txt``
    (one camera-A image of each test identity, drawn per split) and
    ``query_B.txt`` / ``query_C.txt`` (cameras B and C, the same and the
    changed clothes), of ``<path> <pid> <camid> person`` lines."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "prcc", "rgb")

    def images(split: str, pid: int, cam: int, n: int) -> list:
        return [_save(_identity_image(rng, pid, cam, height, width),
                      os.path.join(base, split, f"{pid:03d}", f"cam{cam}_{i}.jpg"))
                for i in range(n)]

    def write(name: str, rows) -> None:
        with open(os.path.join(base, name), "w") as f:
            f.writelines(f"{path} {pid} {cam} person\n" for path, pid, cam in rows)

    os.makedirs(os.path.join(base, "test"), exist_ok=True)
    write("train.txt", [(p, pid, cam) for pid in range(train_ids) for cam in (1, 2)
                        for p in images("train", pid, cam, imgs_per_id)])
    write("val.txt", [(p, pid, 3) for pid in range(train_ids)
                      for p in images("val", pid, 3, 1)])
    test = {cam: {pid: images(f"test/{'ABC'[cam - 1]}", 1000 + pid, cam, imgs_per_id)
                  for pid in range(test_ids)} for cam in (1, 2, 3)}
    for i in range(1, 11):
        write(f"test/gallery_{i}.txt",
              [(test[1][pid][int(rng.integers(imgs_per_id))], 1000 + pid, 1)
               for pid in range(test_ids)])
    for cam, name in ((2, "query_B"), (3, "query_C")):
        write(f"test/{name}.txt", [(p, 1000 + pid, cam) for pid in range(test_ids)
                                   for p in test[cam][pid]])


def make_briar_manifests(root: str, train_ids: int = 6, test_ids: int = 6,
                         gallery_per_id: int = 2, probes_per_id: int = 2,
                         height: int = 64, width: int = 32, seed: int = 12) -> dict:
    """Three BRIAR ``.npy`` manifests under ``root`` (object arrays of
    ``[path, 'G<id>', camera string, distance tag]`` rows over JPEGs written
    beside them): gallery rows at controlled cameras (``enroll_cam<k>``),
    probe rows at field cameras (``field_<range>_cam<k>``, strings disjoint
    from the gallery's) at 100-1000 m, plus, for the reader to drop, one
    close-range probe (tag ``close_range``) of each identity and the probes
    of two identities the gallery lacks → ``{"train", "queries",
    "gallery"}`` paths."""
    rng = np.random.default_rng(seed)
    rows = {"train": [], "queries": [], "gallery": []}

    def emit(split: str, pid: int, cam: str, tag: str, i: int) -> None:
        path = _save(_identity_image(rng, pid, int(rng.integers(1, 4)), height, width),
                     os.path.join(root, split, f"G{pid:05d}_{cam}_{i}.jpg"))
        rows[split].append([path, f"G{pid:05d}", cam, tag])

    for pid in range(train_ids):
        for i in range(2):
            emit("train", pid, f"enroll_cam{i}", "controlled", i)
    for pid in range(100, 100 + test_ids):
        for i in range(gallery_per_id):
            emit("gallery", pid, f"enroll_cam{i % 3}", "controlled", i)
        for i in range(probes_per_id):
            dist = int(rng.choice([100, 200, 400, 500, 1000]))
            emit("queries", pid, f"field_{dist}m_cam{i % 2}", f"{dist}m", i)
        emit("queries", pid, "field_close_cam0", "close_range", probes_per_id)
    for pid in (900, 901):  # probe-only identities
        emit("queries", pid, "field_200m_cam0", "200m", 0)
    out = {}
    for split, r in rows.items():
        out[split] = os.path.join(root, f"{split}.npy")
        np.save(out[split], np.array(r, dtype=object), allow_pickle=True)
    return out
