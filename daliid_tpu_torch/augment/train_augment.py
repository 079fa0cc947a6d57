"""Train-time augmentation of a uint8 batch on its device, through kernel K1.

Port of ``daliid_tpu/augment/train_augment.py::train_augment_batch``
(``:108-118``) with its defaults, the reference's train transform chain
(``Person-ReID/train_encodersKIT.py:313-320``):

    Resize(bicubic, on the host) → RandomCrop(pad=10) → RandomHorizontalFlip(0.5)
    → ColorJitter(0.4, 0.3, 0.4, hue 0) → ToTensor
    → RandomErasing(p=1.0, scale=(0.05, 0.30), ratio=(0.3, 3.3)) → Normalize

It follows the TPU path, not the XLA chain: the per-image scalars are drawn
once per batch by :func:`~daliid_tpu_torch.ops.fused_augment.draw_scalars`
and the uniforms map to knobs as ``daliid_tpu/ops/fused_augment.py:21-24``
documents, so the same distributions as the XLA chain reach different knobs
from one stream. The documented departures from torchvision stay: jitter in
the fixed order brightness → contrast → saturation, and one erase proposal
clamped into bounds instead of up to 10 rejection-sampled attempts.
"""

from __future__ import annotations

import torch

from daliid_tpu_torch.ops.fused_augment import draw_scalars, fused_augment


def train_augment(images_u8: torch.Tensor, generator: torch.Generator, pad: int = 10,
                  brightness: float = 0.4, contrast: float = 0.3, saturation: float = 0.4,
                  erase_scale: tuple = (0.05, 0.30), erase_ratio: tuple = (0.3, 3.3),
                  dtype: torch.dtype = torch.bfloat16, rows: tuple | None = None) -> torch.Tensor:
    """Augment and normalize a (B, H, W, 3) uint8 batch → (B, 3, H, W)
    ``dtype`` in ``channels_last`` memory. The scalars come from the CPU
    ``generator`` and are copied to the images' device. ``rows = (start,
    total)`` marks the batch as rows ``start:start + B`` of a global batch of
    ``total`` (a rank's block): the whole table is drawn and the block's
    rows taken, so each image meets the scalars it would meet in one
    process."""
    b, h, w, _ = images_u8.shape
    start, total = rows if rows is not None else (0, b)
    scal = draw_scalars(total, h, w, pad, brightness, contrast, saturation, erase_scale,
                        erase_ratio, generator)[start:start + b]
    scal = scal.to(images_u8.device, non_blocking=True)
    return fused_augment(images_u8, scal, pad, dtype)
