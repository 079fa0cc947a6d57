"""Fused train augmentation: the scalar draw, the plain version and the CUDA
kernel's wrapper.

Counterpart of ``daliid_tpu/ops/fused_augment.py``: :func:`draw_scalars`
is ``_draw_scalars`` (``:128-150``) and :func:`fused_augment` is
``_augment_core`` (``:153``, Pallas body ``_kernel`` ``:69-125``). For a
(B, H, W, 3) uint8 batch and a (B, 16) f32 table of per-image scalars
(columns ``oy, ox, flip, fb, fc, fs, ey, ex, eh, ew``, then padding) each
image goes through, in this order: crop in output coordinates
``out[y, x] = img[y + oy - pad, x + ox - pad]`` with zero fill; flip;
``x * (1/255)``; brightness, clipped; contrast about the mean gray of the
whole cropped image (zero border included), clipped; saturation about each
pixel's own gray (the gray of the brightened image, as in the JAX kernel),
clipped; erase of ``[ey, ey + eh) x [ex, ex + ew)`` to 0; ImageNet
normalize; a cast to ``dtype``. The zero border is not zero after contrast:
it becomes ``(1 - fc) * mean_gray``.

Kernel note (``csrc/fused_augment.cu``, replaces the TPU kernel above): on
the H100 the least time is the bytes, uint8 in and f32/bf16 out, 0.034 ms
at the train shape (384, 256, 128, 3) in bf16, with the f32 operations
(three IEEE divisions a pixel among them) not far behind. The crop is a
shift and the flip a reversal within a row, so a band of output rows reads
one band of source rows: a cluster of 4 CTAs takes an image, each CTA
staging its band in shared memory once (16-byte ``cp.async``). Pass 1
sums the band's gray from shared memory in double; the 4 band sums are
added in rank order through distributed shared memory, so the mean gray is
the same bits on every run. Pass 2 writes 8 pixels a thread as 16-byte
stores where W is a multiple of 8. A band too large for one stage goes in
sub-bands (and is then read twice). The flip and gray matmuls of the TPU
kernel are index arithmetic here; its roll/mask crop and lane padding are
not carried over.

The table is drawn on the CPU from an explicit ``torch.Generator``, so the
CPU tests and the card see the same stream for a seed; the caller copies it
to the images' device. On a CPU tensor :func:`fused_augment` computes the
plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from daliid_tpu_torch.augment.preprocess import IMAGENET_MEAN, IMAGENET_STD
from daliid_tpu_torch.ops import _build

NUM_SCALARS = 16
_GRAY_W = (0.299, 0.587, 0.114)
# the C entry point: images, scal, B, H, W, pad, out_bf16, out, stream
ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2


def _uniform(n: int, lo: float, hi: float, generator: torch.Generator) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=generator)


def draw_scalars(batch: int, height: int, width: int, pad: int, brightness: float,
                 contrast: float, saturation: float, erase_scale, erase_ratio,
                 generator: torch.Generator) -> torch.Tensor:
    """Per-image augmentation scalars → (B, 16) f32 on the CPU, the
    distributions of ``_draw_scalars``: ``oy, ox`` uniform on ``[0, 2 pad]``;
    flip Bernoulli(0.5); each jitter factor uniform on ``[max(0, 1-b), 1+b]``;
    erase area ``U(scale) * H * W`` and log-aspect ``U(log ratio)``, with
    ``eh = clip(int(sqrt(area * aspect)), 1, H)`` (truncated toward zero),
    ``ey = min(randint(0, H), H - eh)`` and ``ex``, ``ew`` likewise."""
    g = generator
    oy = torch.randint(0, 2 * pad + 1, (batch,), generator=g)
    ox = torch.randint(0, 2 * pad + 1, (batch,), generator=g)
    flip = (torch.rand(batch, generator=g) < 0.5).float()
    fb = _uniform(batch, max(0.0, 1 - brightness), 1 + brightness, g)
    fc = _uniform(batch, max(0.0, 1 - contrast), 1 + contrast, g)
    fs = _uniform(batch, max(0.0, 1 - saturation), 1 + saturation, g)
    area = _uniform(batch, erase_scale[0], erase_scale[1], g) * height * width
    aspect = torch.exp(_uniform(batch, math.log(erase_ratio[0]), math.log(erase_ratio[1]), g))
    eh = torch.sqrt(area * aspect).to(torch.int32).clamp(1, height)
    ew = torch.sqrt(area / aspect).to(torch.int32).clamp(1, width)
    ey = torch.minimum(torch.randint(0, height, (batch,), generator=g, dtype=torch.int32),
                       height - eh)
    ex = torch.minimum(torch.randint(0, width, (batch,), generator=g, dtype=torch.int32),
                       width - ew)
    cols = [oy, ox, flip, fb, fc, fs, ey, ex, eh, ew]
    out = torch.zeros((batch, NUM_SCALARS), dtype=torch.float32)
    out[:, :len(cols)] = torch.stack([c.float() for c in cols], dim=1)
    return out


def fused_augment_plain(images_u8: torch.Tensor, scal: torch.Tensor, pad: int,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The same function in plain PyTorch (any device): (B, H, W, 3) uint8
    and (B, 16) f32 → (B, 3, H, W) ``dtype``, a ``channels_last`` view of a
    contiguous (B, H, W, 3) result. Every step is one f32 operation, in the
    kernel's order."""
    b, h, w, _ = images_u8.shape
    dev = images_u8.device
    oy, ox = scal[:, 0].long(), scal[:, 1].long()
    flip = scal[:, 2] > 0.5
    fb, fc, fs = (scal[:, k].view(b, 1, 1, 1) for k in (3, 4, 5))
    ey, ex, eh, ew = (scal[:, k].long().view(b, 1, 1) for k in (6, 7, 8, 9))
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    # crop and flip as one gather in output coordinates
    src_x = torch.where(flip[:, None], w - 1 - xs[None, :], xs[None, :]) + ox[:, None] - pad
    src_y = ys[None, :] + oy[:, None] - pad
    valid = (((src_y >= 0) & (src_y < h))[:, :, None]
             & ((src_x >= 0) & (src_x < w))[:, None, :])
    bi = torch.arange(b, device=dev).view(b, 1, 1)
    x = images_u8[bi, src_y.clamp(0, h - 1)[:, :, None], src_x.clamp(0, w - 1)[:, None, :]]
    x = torch.where(valid[..., None], x.float(), torch.zeros((), device=dev))
    x = x * (1.0 / 255.0)
    x = torch.clamp(x * fb, 0.0, 1.0)
    gray = (x[..., 0] * _GRAY_W[0] + x[..., 1] * _GRAY_W[1] + x[..., 2] * _GRAY_W[2])[..., None]
    mean_gray = gray.mean(dim=(1, 2, 3)).view(b, 1, 1, 1)
    x = torch.clamp(mean_gray + fc * (x - mean_gray), 0.0, 1.0)
    x = torch.clamp(gray + fs * (x - gray), 0.0, 1.0)
    rows, cols = ys.view(1, h, 1), xs.view(1, 1, w)
    inside = (rows >= ey) & (rows < ey + eh) & (cols >= ex) & (cols < ex + ew)
    x = torch.where(inside[..., None], torch.zeros((), device=dev), x)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)
    x = (x - mean) / std
    return x.to(dtype).permute(0, 3, 1, 2)


def _fn():
    lib = _build.load("fused_augment")
    fn = lib.fused_augment
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def fused_augment(images_u8: torch.Tensor, scal: torch.Tensor, pad: int,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """→ (B, 3, H, W) ``dtype`` (f32 or bf16), a ``channels_last`` view of a
    contiguous (B, H, W, 3) tensor, which the port's ResNet takes without a
    copy.

    ``images_u8`` (B, H, W, 3) uint8; ``scal`` (B, 16) f32 on the same
    device (see :func:`draw_scalars`)."""
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise TypeError(f"images must be (B, H, W, 3) uint8, got {tuple(images_u8.shape)} "
                        f"{images_u8.dtype}")
    b, h, w, _ = images_u8.shape
    if scal.dtype != torch.float32 or scal.shape != (b, NUM_SCALARS):
        raise ValueError(f"scalars must be ({b}, {NUM_SCALARS}) float32, got "
                         f"{tuple(scal.shape)} {scal.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"output dtype must be float32 or bfloat16, got {dtype}")
    if pad < 0:
        raise ValueError(f"pad must be >= 0, got {pad}")
    if images_u8.device != scal.device:
        raise ValueError("images and scalars must be on one device")
    if images_u8.device.type == "cpu":
        return fused_augment_plain(images_u8, scal, pad, dtype)
    out = torch.empty((b, h, w, 3), dtype=dtype, device=images_u8.device)
    if out.numel() == 0:  # nothing to augment: no kernel
        return out.permute(0, 3, 1, 2)
    if images_u8.device.type != "cuda":
        raise RuntimeError(f"fused_augment runs on CUDA or CPU tensors, got {images_u8.device}")
    images_u8, scal = images_u8.contiguous(), scal.contiguous()
    status = _fn()(
        images_u8.data_ptr(), scal.data_ptr(), b, h, w, pad, int(dtype == torch.bfloat16),
        out.data_ptr(), torch.cuda.current_stream(images_u8.device).cuda_stream,
    )
    _build.check(status, "fused_augment")
    fused_augment.launches += 1
    return out.permute(0, 3, 1, 2)


fused_augment.launches = 0
