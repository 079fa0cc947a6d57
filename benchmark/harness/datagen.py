"""Market-1501-shaped JPEG trees made from a seed.

The images follow the program's synthetic generator
(``daliid_tpu_torch/data/synthetic.py``, copied in spirit): each identity
has a colour and stripe signature of its own, each camera shifts the
brightness, each image adds noise (std 4), and each training image has five
turbulence renders (Gaussian blur of radius 0.6 s and noise of std 1.5 s at
strength s). The noise is a window at a random offset into each worker's
bank of normals. Names follow Market-1501 (``<pid>_c<cam>s1_<idx>.jpg``) and
the turbulence copies ``<stem>_turbstrength<s>.jpg``.

Every seed makes the same numbers of identities, images per identity and
files; the seed decides which identity gets which count, the cameras and
the pixels. Trees are written by worker processes (``spawn``) under one
fixed directory of the checkout, keyed by their parameters and the seed,
and only the newest tree of a kind is kept.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import json
import multiprocessing
import os
import shutil

import numpy as np
from PIL import Image, ImageFilter

QUALITY = 90


def _counts(n_ids: int, total: int, lo: int, hi: int) -> np.ndarray:
    """A fixed spread of per-identity counts from ``lo`` to ``hi`` summing
    to ``total``."""
    c = lo + (np.arange(n_ids) * (hi - lo + 1)) // n_ids
    c = c.astype(np.int64)
    diff = total - int(c.sum())
    step = 1 if diff > 0 else -1
    i = 0
    while diff:
        j = i % n_ids
        if lo <= c[j] + step:
            c[j] += step
            diff -= step
        i += 1
    return c


def _noise(bank: np.ndarray, rng, shape, std: float) -> np.ndarray:
    """``std`` x a window of the worker's bank of normals at a random offset:
    far cheaper than fresh normals for every image."""
    n = int(np.prod(shape))
    at = int(rng.integers(0, len(bank) - n))
    return bank[at:at + n].reshape(shape) * std


def _identity_image(look: dict, cam: int, h: int, w: int, rng, bank) -> Image.Image:
    img = np.empty((h, w, 3), np.float32)
    img[:] = look["base"]
    img[(np.arange(h) // look["period"]) % 2 == 0] = look["stripe"]
    img += (cam - 3.5) * 8.0
    img += _noise(bank, rng, img.shape, 4.0)
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))


def _render(img: Image.Image, s: int, rng, bank) -> Image.Image:
    arr = np.asarray(img.filter(ImageFilter.GaussianBlur(radius=0.6 * s)), np.float32)
    arr += _noise(bank, rng, arr.shape, 1.5 * s)
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


def _write_ids(job: dict) -> int:
    """Worker: the images of a block of identities → files written."""
    n = 0
    bank = np.random.default_rng([job["seed"], 7]).standard_normal(1 << 20, np.float32)
    for pid, split_counts, idx in job["ids"]:
        rng = np.random.default_rng([job["seed"], pid, idx])
        look = {"base": rng.integers(40, 216, 3), "stripe": rng.integers(40, 216, 3),
                "period": int(rng.integers(4, 12))}
        for split, count in split_counts:
            for _ in range(count):
                cam = int(rng.integers(1, job["cams"] + 1))
                name = f"{pid:04d}_c{cam}s1_{idx:06d}.jpg"
                idx += 1
                img = _identity_image(look, cam, job["h"], job["w"], rng, bank)
                img.save(os.path.join(job["root"], split, name), quality=QUALITY)
                n += 1
                if split in job["renders"]:
                    for s in range(1, 6):
                        _render(img, s, rng, bank).save(os.path.join(
                            job["root"], "turbulence", f"{name[:-4]}_turbstrength{s}.jpg"),
                            quality=QUALITY)
                        n += 1
    return n


def _key(params: dict, seed: int) -> str:
    blob = json.dumps(params, sort_keys=True) + f"|{seed}"
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def make_tree(cache: str, kind: str, params: dict, seed: int, workers: int) -> str:
    """Write (or find) the tree of ``params`` for ``seed`` under ``cache``
    → its root. ``params``: ``identities`` {group: count}, ``splits``
    {directory: [group, images, fewest, most a identity]}, ``cams``,
    ``height``, ``width``, ``renders`` (the directories with turbulence
    copies) and ``distractors`` {directory: images of pid 0}. Identities
    of a group are numbered in order from 1; splits of one group share them."""
    root = os.path.join(cache, f"{kind}-{_key(params, seed)}")
    if os.path.exists(os.path.join(root, "done")):
        return root
    if os.path.isdir(cache):
        for old in os.listdir(cache):
            if old.startswith(kind + "-"):
                shutil.rmtree(os.path.join(cache, old), ignore_errors=True)
    for d in list(params["splits"]) + ["turbulence"]:
        os.makedirs(os.path.join(root, d), exist_ok=True)
    first, pid0 = 1, {}
    for group, n in params["identities"].items():
        pid0[group] = first
        first += n
    rng = np.random.default_rng(seed)
    per_id: dict = {}
    for split, (group, total, lo, hi) in params["splits"].items():
        n_ids = params["identities"][group]
        counts = rng.permutation(_counts(n_ids, total, lo, hi))
        for i, c in enumerate(counts):
            per_id.setdefault(pid0[group] + i, []).append((split, int(c)))
    items = [(pid, c, 0) for pid, c in sorted(per_id.items())]
    # the distractors (pid 0) in blocks of 16, each block with a look of its own
    for split, total in params.get("distractors", {}).items():
        items += [(0, [(split, min(16, total - i))], i) for i in range(0, total, 16)]
    blocks = [items[i::workers * 4] for i in range(workers * 4)]
    base = dict(seed=int(seed), root=root, cams=params["cams"], h=params["height"],
                w=params["width"], renders=tuple(params.get("renders", ())))
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        written = sum(ex.map(_write_ids, [dict(base, ids=b) for b in blocks if b]))
    with open(os.path.join(root, "done"), "w") as f:
        f.write(str(written))
    # written back now, not during the window
    os.sync()
    return root
