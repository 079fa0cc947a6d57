"""Host decode/resize of image batches + on-device normalize.

Port of ``daliid_tpu/augment/preprocess.py``. The host decodes and resizes
to uint8 HWC: :func:`decode_images` takes the native C++ loader
(``data/native_loader.py``) for a batch of JPEGs, as the JAX package's
extractor and trainer do, and PIL bicubic (``decode_resize``, copied, so the
bytes equal the JAX package's) on a thread pool otherwise. The device
normalizes inside the forward, so the host-to-device copy stays uint8.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Sequence

import numpy as np
import torch
from PIL import Image

from daliid_tpu_torch.data import native_loader

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def decode_resize(path: str, height: int, width: int) -> np.ndarray:
    """Host-side decode + PIL bicubic resize → uint8 (H, W, 3)."""
    img = Image.open(path).convert("RGB")
    if img.size != (width, height):
        img = img.resize((width, height), Image.BICUBIC)
    return np.asarray(img, dtype=np.uint8)


def decode_images(paths: Sequence[str], height: int, width: int, workers: int) -> np.ndarray:
    """Decode + resize ``paths`` → (N, H, W, 3) uint8 with ``workers``
    threads: the native loader when every path is a ``.jpg``/``.jpeg`` and
    the library builds, PIL otherwise."""
    if (all(str(p).lower().endswith((".jpg", ".jpeg")) for p in paths)
            and native_loader.native_loader_available()):
        return native_loader.decode_resize_batch(paths, height, width, num_threads=workers)
    out = np.empty((len(paths), height, width, 3), dtype=np.uint8)

    def work(i):
        out[i] = decode_resize(paths[i], height, width)

    with cf.ThreadPoolExecutor(workers) as ex:
        list(ex.map(work, range(len(paths))))
    return out


def normalize_images(images_u8: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(x/255 - mean)/std`` over a (B, H, W, 3) uint8 batch on its device.

    Returns the batch NCHW-logical in ``torch.channels_last`` memory (a
    permuted view of the NHWC result, no copy), in ``dtype``. The affine is
    computed in f32 as ``x * (1/255/std) + (-mean/std)``, the JAX package's
    folding."""
    dev = images_u8.device
    mean_t = torch.tensor(mean, dtype=torch.float32, device=dev)
    std_t = torch.tensor(std, dtype=torch.float32, device=dev)
    scale = (1.0 / 255.0) / std_t
    bias = -mean_t / std_t
    x = images_u8.to(torch.float32) * scale + bias
    return x.to(dtype).permute(0, 3, 1, 2)
