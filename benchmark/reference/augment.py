"""DaliID's train-time augmentation and the host decode, written out plainly.

The reference chain (``Person-ReID/train_encodersKIT.py:313-320``):
bicubic resize on the host, then per image a crop with 10 pixels of zero
padding, a horizontal flip at 0.5, colour jitter (brightness 0.4, contrast
0.3 about the mean gray of the whole cropped image, saturation 0.4 about
each pixel's gray), one random erase of 5-30% of the area at aspect 0.3-3.3,
and the ImageNet normalization. The per-image scalars are drawn once per
batch from a CPU ``torch.Generator`` in a fixed order (crop offsets, flip,
the three jitter factors, erase area and aspect, erase origin), so a
generator seeded alike draws the same table.
"""

from __future__ import annotations

import concurrent.futures as cf
import math

import numpy as np
import torch
from PIL import Image

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
GRAY = (0.299, 0.587, 0.114)
PAD, BRIGHT, CONTRAST, SAT = 10, 0.4, 0.3, 0.4
ERASE_SCALE, ERASE_RATIO = (0.05, 0.30), (0.3, 3.3)


def decode(paths, height: int, width: int, workers: int = 8) -> np.ndarray:
    """JPEG decode and PIL bicubic resize → (N, H, W, 3) uint8."""
    out = np.empty((len(paths), height, width, 3), np.uint8)

    def one(i):
        img = Image.open(paths[i]).convert("RGB")
        if img.size != (width, height):
            img = img.resize((width, height), Image.BICUBIC)
        out[i] = np.asarray(img, np.uint8)

    with cf.ThreadPoolExecutor(workers) as ex:
        list(ex.map(one, range(len(paths))))
    return out


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (B, 3, H, W) float32, ``(x / 255 - mean) / std``."""
    x = images_u8.float() / 255.0
    x = (x - torch.tensor(MEAN, device=x.device)) / torch.tensor(STD, device=x.device)
    return x.permute(0, 3, 1, 2).contiguous()


def _u(n, lo, hi, g):
    return lo + (hi - lo) * torch.rand(n, generator=g)


def draw(batch: int, h: int, w: int, g: torch.Generator) -> dict:
    """The batch's per-image scalars, in the order they are drawn."""
    oy = torch.randint(0, 2 * PAD + 1, (batch,), generator=g)
    ox = torch.randint(0, 2 * PAD + 1, (batch,), generator=g)
    flip = torch.rand(batch, generator=g) < 0.5
    fb = _u(batch, 1 - BRIGHT, 1 + BRIGHT, g)
    fc = _u(batch, 1 - CONTRAST, 1 + CONTRAST, g)
    fs = _u(batch, 1 - SAT, 1 + SAT, g)
    area = _u(batch, *ERASE_SCALE, g) * h * w
    aspect = torch.exp(_u(batch, math.log(ERASE_RATIO[0]), math.log(ERASE_RATIO[1]), g))
    eh = torch.sqrt(area * aspect).to(torch.int32).clamp(1, h)
    ew = torch.sqrt(area / aspect).to(torch.int32).clamp(1, w)
    ey = torch.minimum(torch.randint(0, h, (batch,), generator=g, dtype=torch.int32), h - eh)
    ex = torch.minimum(torch.randint(0, w, (batch,), generator=g, dtype=torch.int32), w - ew)
    return dict(oy=oy, ox=ox, flip=flip, fb=fb, fc=fc, fs=fs, ey=ey, ex=ex, eh=eh, ew=ew)


def augment(images_u8: torch.Tensor, s: dict) -> torch.Tensor:
    """(B, H, W, 3) uint8 and the scalars of :func:`draw` → (B, 3, H, W)
    float32, image by image."""
    b, h, w, _ = images_u8.shape
    dev = images_u8.device
    mean = torch.tensor(MEAN, device=dev)
    std = torch.tensor(STD, device=dev)
    out = torch.empty((b, 3, h, w), device=dev)
    for i in range(b):
        img = images_u8[i].float() / 255.0
        padded = torch.zeros((h + 2 * PAD, w + 2 * PAD, 3), device=dev)
        padded[PAD:PAD + h, PAD:PAD + w] = img
        oy, ox = int(s["oy"][i]), int(s["ox"][i])
        x = padded[oy:oy + h, ox:ox + w]
        if bool(s["flip"][i]):
            x = x.flip(1)
        x = (x * float(s["fb"][i])).clamp(0, 1)
        gray = (x * torch.tensor(GRAY, device=dev)).sum(-1, keepdim=True)
        x = (gray.mean() + float(s["fc"][i]) * (x - gray.mean())).clamp(0, 1)
        x = (gray + float(s["fs"][i]) * (x - gray)).clamp(0, 1)
        ey, ex, eh, ew = (int(s[k][i]) for k in ("ey", "ex", "eh", "ew"))
        x[ey:ey + eh, ex:ex + ew] = 0.0
        out[i] = ((x - mean) / std).permute(2, 0, 1)
    return out
