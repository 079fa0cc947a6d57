"""Fused multi-head attention: the plain version, its gradient and the CUDA
kernel's wrapper.

Counterpart of ``daliid_tpu/ops/flash_attention.py``: :func:`flash_attention`
is the entry ``flash_attention`` (``:119``), whose Pallas body
``_attention_kernel`` (``:32``, ``pallas_call`` in ``_fused_attention``
``:55``) computes, for every batch row and head of (B, N, H, D) inputs,

    softmax(q . k^T * D^-1/2) . v

in f32 whatever the input type (upcast, scores times the scale, row max,
``exp(s - max)``, row sum, ``p / sum``, ``p . v``), and casts the result to
the input type. Its gradient is the JAX package's custom VJP: the forward
saves q, k and v, not the probabilities (``_fwd`` ``:94``), and the backward
(``_bwd`` ``:98-113``) recomputes P in plain f32 arithmetic and forms dV, dP,
dS, dQ and dK. The JAX package runs that backward in XLA, outside any Pallas
kernel, so here it is plain PyTorch (:func:`attention_backward`) too.

Kernel note (``csrc/flash_attention.cu``, replaces the TPU kernel above):
one block of 4 or 8 warps, 16 query rows each, per (batch row, head, query
tile). On the H100 the least time at the JPM trunk's shape (384, 211, 12,
64) in bf16 is the bytes, 0.149 ms. In bf16, the type of every timed and
main path, both products run on the tensor cores (``mma.sync`` m16n8k16, f32
accumulate): K and V come into shared memory in 64-key tiles by 16-byte
``cp.async`` copies (double-buffered, rows past N zero-filled), the scores
stay in registers through an online softmax, and P enters P·V as two bf16
parts (``P_hi = bf16(P)``, ``P_lo = bf16(P - P_hi)``) so that the result
stays within one bf16 ulp of the f32 plain version; it is rounded once, at
the store. In f32 (checks only) the products run on the CUDA cores. q, k and
v may be strided (B, N, H, D) views, such as the column blocks of the ViT's
fused qkv projection; the wrapper copies only a view the kernel cannot read
(a non-unit D stride, or in bf16 a base or stride that is not a multiple of
16 bytes). PERF.md has the times. The TPU kernel's transposes and its
padding of N and D to multiples of 128 are not carried over.

On CPU tensors :func:`flash_attention` computes the plain version; on CUDA
tensors it launches the kernel or raises. The kernel takes D in {32, 64, 96}
and any N >= 1, in f32 or bf16.
"""

from __future__ import annotations

import ctypes

import torch

from daliid_tpu_torch.ops import _build

HEAD_DIMS = (32, 64, 96)
# the C entry point: q, k, v, 9 strides, B, N, H, D, scale, is_bf16, out, stream
ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 2)


def _scale(d: int) -> float:
    return 1.0 / (d ** 0.5)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (any device), in the Pallas
    body's order: (B, N, H, D) q, k, v → contiguous (B, N, H, D) in q's
    dtype."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * _scale(q.shape[-1])
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhnm,bmhd->bnhd", p, vf).to(q.dtype).contiguous()


def attention_backward(q, k, v, g):
    """The JAX VJP's backward (``_bwd``): recompute P in f32, then
    → (dq, dk, dv) in the inputs' dtypes."""
    scale = _scale(q.shape[-1])
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, g))
    s = torch.einsum("bnhd,bmhd->bhnm", q32, k32) * scale
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhnm,bnhd->bmhd", p, g32)
    dp = torch.einsum("bnhd,bmhd->bhnm", g32, v32)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k32) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _fn():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be (B, N, H, D) of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must share a dtype, float32 or bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _kernel_reads(t: torch.Tensor) -> bool:
    """Whether the kernel takes the view ``t`` as it is: unit stride on D,
    and in bf16 (16-byte ``cp.async`` copies of rows) a 16-byte-aligned base
    and 16-byte strides on every dimension longer than 1. The ViT's qkv
    column blocks are (row stride 3·H·D·2 bytes, head offsets 128·h)."""
    if t.stride(-1) != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    return t.data_ptr() % 16 == 0 and all(
        (s * t.element_size()) % 16 == 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def _forward(q, k, v) -> torch.Tensor:
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:  # nothing to attend: no kernel
        return out
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes head dims {HEAD_DIMS}, got {d}")
    q, k, v = (t if _kernel_reads(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    status = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, b, n, h, d, _scale(d),
        int(q.dtype == torch.bfloat16), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_attention")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version) forward; the JAX VJP's
    recomputing backward. Saves q, k and v, not P."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return attention_backward(*ctx.saved_tensors, g)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused attention over (B, N, H, D) q, k, v → contiguous (B, N, H, D)
    in their dtype, differentiable; the counterpart of the JAX package's
    ``flash_attention`` (scale ``D^-1/2``; fold another scale into q)."""
    return _FlashAttention.apply(q, k, v)


flash_attention.launches = 0
