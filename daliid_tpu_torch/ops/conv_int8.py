"""Int8 convolution with int32 accumulation and a dequantize epilogue: the
plain version and the CUDA kernel's wrapper.

Counterpart of the int8 convolution of ``daliid_tpu/ops/quantize.py``
(``make_quantized_interceptor``, ``:278-290``): ``lax.conv_general_dilated``
on int8 inputs with ``preferred_element_type=int32``, then

    out = float32(acc) * (s_in * s_w[o]) (+ bias[o]), cast to the result type.

That is XLA there, not a Pallas kernel; on the H100 PyTorch has no CUDA
int8 convolution (its quantized convolutions run on the CPU only and
``F.conv2d`` on CUDA refuses integer tensors), so this kernel exists only in
the port (``csrc/conv_int8.cu``: an implicit GEMM on the int8 tensor cores
for ``groups == 1``, a direct per-output loop for depthwise convolutions;
its note gives the bound and the design).

Shapes: ``xq`` int8 (B, C, H, W), NCHW-logical, ideally ``channels_last``
in memory (the kernel reads NHWC; another layout is copied first); ``wq``
int8 (O, kh, kw, C / groups); ``stride`` and ``padding`` (h, w) pairs,
symmetric padding; ``s_in`` a float (an f32 value); ``s_w`` f32 (O,);
``bias`` f32 (O,) or None. The result is (B, O, Ho, Wo) in ``out_dtype``
(float32, bfloat16, or int32 for the raw sum) in ``channels_last`` memory.

The int32 sum is exact (``|acc| <= K * 127**2``, below 2**31 for every
convolution of the model zoo), so the kernel and the plain version agree
bit for bit. On a CPU tensor :func:`conv_int8` computes the plain version;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from daliid_tpu_torch.ops import _build

_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def conv_out_hw(h: int, w: int, kernel, stride, padding) -> tuple[int, int]:
    """Output (Ho, Wo) of a convolution with symmetric padding."""
    return ((h + 2 * padding[0] - kernel[0]) // stride[0] + 1,
            (w + 2 * padding[1] - kernel[1]) // stride[1] + 1)


def _check_groups(groups: int, c: int, o: int) -> None:
    if groups != 1 and not groups == c == o:
        raise NotImplementedError(f"conv_int8: groups={groups} with C {c} and O {o}; it takes "
                                  f"groups == 1 or depthwise (groups == C == O)")


def conv_int32_plain(xq, wq, stride, padding, groups: int) -> torch.Tensor:
    """The exact int32 sum in plain PyTorch, for ``groups == 1`` and
    depthwise convolutions. ``groups == 1``: im2col (``F.unfold``) and one
    float64 matrix product on the int8 values, where every partial sum is an
    integer below 2**53, so any summation order is exact; depthwise: the
    kh x kw taps added one by one in int32 over the whole batch. (A float64
    ``F.conv2d`` takes a slow path on the CPU, 0.2 s for a 3-channel stem of
    16 small images, and one small product per channel when grouped.)"""
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    o, kh, kw, cg = wq.shape
    n_b, c, h, w = xq.shape
    ho, wo = conv_out_hw(h, w, (kh, kw), (sh, sw), (ph, pw))
    if groups == 1:
        cols = F.unfold(xq.double(), (kh, kw), padding=(ph, pw), stride=(sh, sw))
        acc = torch.matmul(wq.permute(0, 3, 1, 2).reshape(o, -1).double(), cols)
        return acc.view(n_b, o, ho, wo).to(torch.int32).contiguous(
            memory_format=torch.channels_last)
    _check_groups(groups, c, o)
    x = F.pad(xq.to(torch.int32), (pw, pw, ph, ph))
    wt = wq.to(torch.int32)
    acc = torch.zeros((n_b, o, ho, wo), dtype=torch.int32, device=xq.device)
    for r in range(kh):
        for s in range(kw):
            acc += (x[:, :, r:r + sh * (ho - 1) + 1:sh, s:s + sw * (wo - 1) + 1:sw]
                    * wt[:, r, s, 0].view(1, -1, 1, 1))
    return acc.contiguous(memory_format=torch.channels_last)


def dequantize_plain(acc, s_in: float, s_w, bias, out_dtype) -> torch.Tensor:
    """The epilogue in plain PyTorch: ``float32(acc) * (s_in * s_w)``, then
    ``+ bias``, each one f32 operation, then the cast."""
    if out_dtype == torch.int32:
        return acc
    scale = torch.full((), s_in, dtype=torch.float32, device=acc.device) * s_w
    out = acc.float() * scale.view(1, -1, 1, 1)
    if bias is not None:
        out = out + bias.float().view(1, -1, 1, 1)
    return out.to(out_dtype).contiguous(memory_format=torch.channels_last)


def conv_int8_plain(xq, wq, stride, padding, groups: int, s_in: float, s_w, bias=None,
                    out_dtype=torch.float32) -> torch.Tensor:
    """The same function in plain PyTorch (any device)."""
    return dequantize_plain(conv_int32_plain(xq, wq, stride, padding, groups), s_in, s_w,
                            bias, out_dtype)


def _fn():
    fn = _build.load("conv_int8").conv_int8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def conv_int8(xq, wq, stride, padding, groups: int, s_in: float, s_w, bias=None,
              out_dtype=torch.float32) -> torch.Tensor:
    """→ (B, O, Ho, Wo) ``out_dtype``, channels_last; see the module note."""
    stride, padding = _pair(stride), _pair(padding)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError("xq and wq must be int8")
    if xq.dim() != 4 or wq.dim() != 4:
        raise ValueError(f"xq (B, C, H, W) and wq (O, kh, kw, C/groups), got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    n_b, c, h, w = xq.shape
    o, kh, kw, cg = wq.shape
    if groups < 1 or c % groups or o % groups or cg != c // groups:
        raise ValueError(f"groups {groups} does not fit C {c}, O {o} and wq's C/groups {cg}")
    _check_groups(groups, c, o)
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"out_dtype must be float32, bfloat16 or int32, got {out_dtype}")
    if s_w.dtype != torch.float32 or s_w.shape != (o,):
        raise ValueError(f"s_w must be f32 ({o},)")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (o,)):
        raise ValueError(f"bias must be f32 ({o},)")
    if min(stride) < 1 or min(padding) < 0:
        raise ValueError(f"stride {stride} and padding {padding}")
    ho, wo = conv_out_hw(h, w, (kh, kw), stride, padding)
    if ho < 1 or wo < 1:
        raise ValueError(f"the kernel {kh}x{kw} does not fit the padded {h}x{w} input")
    tensors = [xq, wq, s_w] + ([] if bias is None else [bias])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must be on one device")
    if xq.device.type == "cpu":
        return conv_int8_plain(xq, wq, stride, padding, groups, s_in, s_w, bias, out_dtype)
    if xq.device.type != "cuda":
        raise RuntimeError(f"conv_int8 runs on CUDA or CPU tensors, got {xq.device}")
    out = torch.empty((n_b, ho, wo, o), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:  # an empty batch: nothing to launch
        return out.permute(0, 3, 1, 2)
    x_nhwc = xq.permute(0, 2, 3, 1).contiguous()  # no copy for a channels_last tensor
    w_c, s_c = wq.contiguous(), s_w.contiguous()
    b_c = None if bias is None else bias.contiguous()
    status = _fn()(
        x_nhwc.data_ptr(), w_c.data_ptr(), s_c.data_ptr(),
        None if b_c is None else b_c.data_ptr(), out.data_ptr(),
        n_b, h, w, c, o, kh, kw, stride[0], stride[1], padding[0], padding[1], groups,
        float(s_in), _OUT_KIND[out_dtype], torch.cuda.current_stream(xq.device).cuda_stream,
    )
    _build.check(status, "conv_int8")
    conv_int8.launches += 1
    return out.permute(0, 3, 1, 2)


conv_int8.launches = 0
