"""Eval-path preprocessing: host bicubic decode/resize + on-device normalize.

Port of ``daliid_tpu/augment/preprocess.py``. The host decodes and resizes
to uint8 HWC with PIL bicubic (``decode_resize``, copied, so the bytes equal
the JAX package's); the device normalizes inside the forward, so the
host-to-device copy stays uint8.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def decode_resize(path: str, height: int, width: int) -> np.ndarray:
    """Host-side decode + PIL bicubic resize → uint8 (H, W, 3)."""
    img = Image.open(path).convert("RGB")
    if img.size != (width, height):
        img = img.resize((width, height), Image.BICUBIC)
    return np.asarray(img, dtype=np.uint8)


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
