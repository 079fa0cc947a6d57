"""Deterministic synthetic re-ID dataset (+ turbulence companions).

Copy of ``daliid_tpu/data/synthetic.py::make_synthetic_dataset`` (``:72``)
and its image helpers: a Market-1501-shaped tree of small JPEGs where each
identity has a distinctive color/stripe signature. The same seed writes the
same files as the JAX package's generator (numpy ``default_rng`` and PIL,
step for step).
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
