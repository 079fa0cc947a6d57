"""Int8 convolution that quantizes its floating-point input, sums in int32
and dequantizes in its epilogue: the plain version and the CUDA kernel's
wrapper.

Counterpart of a quantized convolution of ``daliid_tpu/ops/quantize.py``:
``_quantize_sym(x, s_in)`` (``:108-110``) and then, in
``make_quantized_interceptor`` (``:272-290``), ``lax.conv_general_dilated``
on int8 inputs with ``preferred_element_type=int32``, then

    out = float32(acc) * (s_in * s_w[o]) (+ bias[o]), cast to the result type.

That is XLA there (which fuses the quantize into the convolution's
producer), not a Pallas kernel; on the H100 PyTorch has no CUDA int8
convolution, so this kernel exists only in the port. ``csrc/conv_int8.cu``
reads the layer's bf16 or f32 input and quantizes it while loading it, to
the code :func:`quantize_sym` gives (a screen by the reciprocal, the true
division wherever the screen cannot decide), so no int8 copy of the input is
ever written: an implicit GEMM on warpgroup MMA for ``groups == 1``, its A
tile built from an input window staged in shared memory (each input
quantized once a tile of pixels) or, for strided 1x1 convolutions and
windows too large, gathered from the input (:func:`kernel_plan`), and a
staged direct loop for depthwise convolutions. Its note gives the bound (the
input at its own element size, the int8 weights and the output once each,
or the int8 tensor cores' operations) and the design.

Shapes: ``x`` (B, C, H, W), NCHW-logical, ideally ``channels_last`` in
memory (the kernel reads NHWC; another layout is copied first), in bf16 or
f32, quantized with ``s_in``, or int8 taken as already quantized (``s_in``
then only scales the result); ``wq`` int8 (O, kh, kw, C / groups);
``stride`` and ``padding`` (h, w) pairs, symmetric padding; ``s_in`` a float
(an f32 value, finite and > 0 for a float ``x``); ``s_w`` f32 (O,);
``bias`` f32 (O,) or None. The result is (B, O, Ho, Wo) in ``out_dtype``
(float32, bfloat16, or int32 for the raw sum) in ``channels_last`` memory.
On the card the kernel reads the weights as :func:`pack_weights` lays them
out; a caller that convolves many times packs once and passes ``w_packed``.

The int32 sum is exact (``|acc| <= K * 127**2``, below 2**31 for every
convolution of the model zoo) and the kernel's quantize gives the plain
version's codes, so the kernel and the plain version agree bit for bit. On a CPU
tensor :func:`conv_int8` computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from daliid_tpu_torch.ops import _build

_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
_IN_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
# the blocks the kernel chooses among (csrc/conv_int8.cu, conv_int8_plan)
PLANS = {0: "gathering", 1: "staged, 128-pixel tiles", 2: "staged, 64-pixel tiles",
         3: "depthwise", -1: "refused"}
# bytes of K in one stage of the implicit GEMM, and the swizzle's 16-byte
# chunks in such a row
STAGE_K, CHUNK = 128, 16
# depthwise kernel sizes the kernel takes (kh, kw), at column stride 1 or 2
DEPTHWISE_KERNELS = ((3, 3), (5, 5))


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def conv_out_hw(h: int, w: int, kernel, stride, padding) -> tuple[int, int]:
    """Output (Ho, Wo) of a convolution with symmetric padding."""
    return ((h + 2 * padding[0] - kernel[0]) // stride[0] + 1,
            (w + 2 * padding[1] - kernel[1]) // stride[1] + 1)


def _check_groups(groups: int, c: int, o: int) -> None:
    if groups != 1 and not groups == c == o:
        raise NotImplementedError(f"conv_int8: groups={groups} with C {c} and O {o}; it takes "
                                  f"groups == 1 or depthwise (groups == C == O)")


def quantize_sym(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantization in f32: ``clip(round(x / scale), -127,
    127)`` (round half to even); ``scale`` a tensor on ``x``'s device (on
    CUDA, PyTorch divides by a host scalar as a multiply by its
    reciprocal)."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


def weight_layout(c_per_group: int, groups: int) -> str:
    """How :func:`pack_weights` lays out a convolution's weights: ``c8``
    (groups == 1, C a multiple of 8: K in the order (r, s, c)), ``c4``
    (groups == 1 otherwise, each tap's channels padded to a multiple of 4:
    the 3-channel stems) or ``depthwise``."""
    if groups != 1:
        return "depthwise"
    return "c8" if c_per_group % 8 == 0 else "c4"


def block_n(o: int) -> int:
    """Output channels of one implicit-GEMM tile: the smallest of 32, 64,
    128 and 256 that holds ``o``, else 256."""
    return min(256, max(32, 1 << (o - 1).bit_length()))


def _tap_channels(cg: int, layout: str) -> int:
    """Channels a tap holds in K: C, or C rounded up to 4 (``c4``)."""
    return _round_up(cg, 4) if layout == "c4" else cg


def _swizzle_index(bn: int, device) -> torch.Tensor:
    """(bn, 8): stored chunk d of row n holds chunk d ^ (n % 8) (the 128-byte
    swizzle; XOR is its own inverse)."""
    return (torch.arange(8, device=device).view(1, 8)
            ^ (torch.arange(bn, device=device) % 8).view(bn, 1))


def pack_weights(wq: torch.Tensor, groups: int) -> torch.Tensor:
    """``wq`` int8 (O, kh, kw, C / groups) → the layout the kernel reads, a
    flat int8 tensor: zero padding and a permutation, undone by
    :func:`unpack_weights`.

    groups == 1: K in the order (r, s, c), each tap's channels padded to
    ``C4`` for the ``c4`` layout; rows padded to the tile's ``BN`` and K to
    the 128-byte stage; laid out [n tile][K stage][row][chunk][16], each row
    of a stage in the 128-byte swizzle, so one TMA bulk copy brings a
    stage's B tile as wgmma reads it. Depthwise: (kh * kw, O padded to 8),
    a tap's channels together."""
    o, kh, kw, cg = wq.shape
    layout = weight_layout(cg, groups)
    if layout == "depthwise":
        w = wq.reshape(o, kh * kw).t()
        return F.pad(w, (0, _round_up(o, 8) - o)).contiguous().view(-1)
    c4 = _tap_channels(cg, layout)
    k = kh * kw * c4
    bn, k_pad = block_n(o), _round_up(k, STAGE_K)
    w = F.pad(wq, (0, c4 - cg)).reshape(o, k)
    w = F.pad(w, (0, k_pad - k, 0, _round_up(o, bn) - o))
    w = w.view(-1, bn, k_pad // STAGE_K, STAGE_K // CHUNK, CHUNK)
    idx = _swizzle_index(bn, w.device).view(1, bn, 1, STAGE_K // CHUNK, 1).expand(w.shape)
    return torch.gather(w, 3, idx).permute(0, 2, 1, 3, 4).contiguous().view(-1)


def packed_numel(shape, groups: int) -> int:
    """Bytes of :func:`pack_weights` for weights of ``shape`` (O, kh, kw,
    C / groups)."""
    o, kh, kw, cg = shape
    layout = weight_layout(cg, groups)
    if layout == "depthwise":
        return kh * kw * _round_up(o, 8)
    k = kh * kw * _tap_channels(cg, layout)
    return _round_up(o, block_n(o)) * _round_up(k, STAGE_K)


def unpack_weights(packed: torch.Tensor, shape, groups: int) -> torch.Tensor:
    """The inverse of :func:`pack_weights`: → int8 ``shape`` = (O, kh, kw,
    C / groups)."""
    o, kh, kw, cg = shape
    layout = weight_layout(cg, groups)
    if layout == "depthwise":
        return packed.view(kh * kw, -1)[:, :o].t().reshape(o, kh, kw, 1)
    c4 = _tap_channels(cg, layout)
    k = kh * kw * c4
    bn, k_pad = block_n(o), _round_up(k, STAGE_K)
    w = packed.view(-1, k_pad // STAGE_K, bn, STAGE_K // CHUNK, CHUNK).permute(0, 2, 1, 3, 4)
    idx = _swizzle_index(bn, w.device).view(1, bn, 1, STAGE_K // CHUNK, 1).expand(w.shape)
    w = torch.gather(w, 3, idx).reshape(-1, k_pad)[:o, :k]
    return w.reshape(o, kh, kw, c4)[..., :cg].contiguous()


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


def conv_int8_plain(x, wq, stride, padding, groups: int, s_in: float, s_w, bias=None,
                    out_dtype=torch.float32) -> torch.Tensor:
    """The same function in plain PyTorch (any device): a float ``x`` goes
    through :func:`quantize_sym` with ``s_in`` as an f32 tensor first."""
    xq = x if x.dtype == torch.int8 else quantize_sym(
        x, torch.full((), s_in, dtype=torch.float32, device=x.device))
    return dequantize_plain(conv_int32_plain(xq, wq, stride, padding, groups), s_in, s_w,
                            bias, out_dtype)


def _fn():
    fn = _build.load("conv_int8").conv_int8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 13 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def kernel_plan(x_shape, w_shape, stride, padding, groups: int) -> str:
    """The block the kernel takes for a convolution of ``x_shape`` (B, C, H,
    W) by ``w_shape`` (O, kh, kw, C / groups), one of :data:`PLANS`' values:
    asked of the built library (so on the machine with the GPU), which
    decides from the geometry alone."""
    fn = _build.load("conv_int8").conv_int8_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 13
        fn.restype = ctypes.c_int
    (n_b, c, h, w), (o, kh, kw, _) = x_shape, w_shape
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    return PLANS[fn(n_b, h, w, c, o, kh, kw, sh, sw, ph, pw, groups, block_n(o))]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with its first byte on a 16-byte boundary."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def conv_int8(x, wq, stride, padding, groups: int, s_in: float, s_w, bias=None,
              out_dtype=torch.float32, w_packed=None) -> torch.Tensor:
    """→ (B, O, Ho, Wo) ``out_dtype``, channels_last; see the module note."""
    stride, padding = _pair(stride), _pair(padding)
    if x.dtype not in _IN_KIND:
        raise TypeError(f"x must be int8 (quantized), bfloat16 or float32, got {x.dtype}")
    if wq.dtype != torch.int8:
        raise TypeError(f"wq must be int8, got {wq.dtype}")
    if x.dim() != 4 or wq.dim() != 4:
        raise ValueError(f"x (B, C, H, W) and wq (O, kh, kw, C/groups), got "
                         f"{tuple(x.shape)} and {tuple(wq.shape)}")
    if x.dtype != torch.int8 and not (math.isfinite(s_in) and s_in > 0):
        raise ValueError(f"a float x needs a finite s_in > 0, got {s_in}")
    n_b, c, h, w = x.shape
    o, kh, kw, cg = wq.shape
    if groups < 1 or c % groups or o % groups or cg != c // groups:
        raise ValueError(f"groups {groups} does not fit C {c}, O {o} and wq's C/groups {cg}")
    _check_groups(groups, c, o)
    if groups != 1 and ((kh, kw) not in DEPTHWISE_KERNELS or stride[1] not in (1, 2)):
        raise NotImplementedError(f"conv_int8: a depthwise {kh}x{kw} kernel at stride "
                                  f"{stride}; it takes 3x3 and 5x5 at column strides 1 and 2")
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
    tensors = [x, wq, s_w] + ([] if bias is None else [bias]) + (
        [] if w_packed is None else [w_packed])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must be on one device")
    if w_packed is not None and (w_packed.dtype != torch.int8
                                 or w_packed.numel() != packed_numel(wq.shape, groups)):
        raise ValueError("w_packed is not pack_weights(wq, groups)")
    if x.device.type == "cpu":
        return conv_int8_plain(x, wq, stride, padding, groups, s_in, s_w, bias, out_dtype)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv_int8 runs on CUDA or CPU tensors, got {x.device}")
    out = torch.empty((n_b, ho, wo, o), dtype=out_dtype, device=x.device)
    if out.numel() == 0:  # an empty batch: nothing to launch
        return out.permute(0, 3, 1, 2)
    if w_packed is None:
        w_packed = pack_weights(wq, groups)
    x_nhwc = _aligned(x.permute(0, 2, 3, 1))  # no copy for an aligned channels_last tensor
    w_c, s_c = _aligned(w_packed), s_w.contiguous()
    b_c = None if bias is None else bias.contiguous()
    status = _fn()(
        x_nhwc.data_ptr(), _IN_KIND[x.dtype], w_c.data_ptr(), s_c.data_ptr(),
        None if b_c is None else b_c.data_ptr(), out.data_ptr(),
        n_b, h, w, c, o, kh, kw, stride[0], stride[1], padding[0], padding[1],
        groups, block_n(o), float(s_in), _OUT_KIND[out_dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "conv_int8")
    conv_int8.launches += 1
    return out.permute(0, 3, 1, 2)


conv_int8.launches = 0
