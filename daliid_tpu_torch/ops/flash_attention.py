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
kernel; here its plain PyTorch version is :func:`attention_backward`, and
the card runs kernels of the port's own (below).

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

With an additive ``bias`` (windowed attention, Swin's relative-position bias
and shift mask; no TPU kernel counterpart, the JAX package has no such
model) the function is

    softmax(q . k^T * D^-1/2 + bias[b % G]) . v

for batch row b and a (G, H, N, N) f32 ``bias``: G is the number of windows
of an image (batch rows are ``image * G + window``), or 1 where every window
takes the same bias. Its gradient is the same recomputing backward, which
also returns ``dbias``, the sum of dS over the images. On the card the
biased forward is a kernel of its own (``wattn_bias_mma`` in
``csrc/flash_attention.cu``: bf16, D = 32, N <= 64, one block a
window and head), so the unbiased kernel and its launches are as they were;
its launches count in ``flash_attention.bias_launches``.

The backward of both autograd Functions is hand-written CUDA too
(``csrc/attention_grad.cu``, a library of its own; it replaces no TPU kernel:
the JAX package's backward is XLA). On CPU tensors it is
:func:`attention_backward`; on CUDA tensors the wrapper launches the kernels
or raises, for every call the forward kernels take. Unbiased: ``k4_grad_dq``
(dQ and the rows' log-sum-exp and delta, f32 scratch) then ``k4_grad_dkv``
(dK and dV), in bf16 on the tensor cores with P and dS entering their
products as two bf16 parts, or in f32 on the CUDA cores (checks); biased:
``wattn_grad_mma``, whose blocks each walk a chunk of one window's images and
write a partial sum of dS, summed here into ``dbias``. No float atomics:
two calls give the same bits. One count a backward call:
``flash_attention.grad_launches`` and ``flash_attention.bias_grad_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from daliid_tpu_torch.ops import _build

HEAD_DIMS = (32, 64, 96)
# the C entry point: q, k, v, 9 strides, B, N, H, D, scale, is_bf16, out, stream
ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 2)
# the biased kernel: head dims, the longest window, and its C entry point
# (q, k, v, 9 strides, bias, B, N, H, D, G, scale, out, stream)
BIAS_HEAD_DIMS = (32,)
BIAS_MAX_N = 64
BIAS_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 9 + [ctypes.c_void_p]
                 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 2)
# the backward's C entry points: q, k, v, dO, 12 strides, B, N, H, D, scale,
# is_bf16, dq, dk, dv, lse, delta, stream; and with the bias: q, k, v, dO, 12
# strides, bias, B, N, H, D, G, chunks, scale, dq, dk, dv, dbias partials, stream
GRAD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 4
                 + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 6)
BIAS_GRAD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12 + [ctypes.c_void_p]
                      + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_void_p] * 5)
# the biased backward's blocks a call, about: (window, head) pairs times chunks
# of images, each chunk's dbias summed in a partial of its own
BIAS_GRAD_BLOCKS = 1024


def _scale(d: int) -> float:
    return 1.0 / (d ** 0.5)


def _biased(s: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """(B, H, N, N) scores plus ``bias[b % G]`` for batch row b."""
    if bias is None:
        return s
    b, h, n, _ = s.shape
    g = bias.shape[0]
    return (s.view(b // g, g, h, n, n) + bias.float()).view(b, h, n, n)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """The same function in plain PyTorch (any device), in the Pallas
    body's order: (B, N, H, D) q, k, v and an optional (G, H, N, N) bias →
    contiguous (B, N, H, D) in q's dtype."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = _biased(torch.einsum("bnhd,bmhd->bhnm", qf, kf) * _scale(q.shape[-1]), bias)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhnm,bmhd->bnhd", p, vf).to(q.dtype).contiguous()


def attention_backward(q, k, v, g, bias=None):
    """The JAX VJP's backward (``_bwd``): recompute P in f32, then
    → (dq, dk, dv) in the inputs' dtypes; with a (G, H, N, N) ``bias`` also
    its gradient, dS summed over the images, in the bias's dtype."""
    scale = _scale(q.shape[-1])
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, g))
    s = _biased(torch.einsum("bnhd,bmhd->bhnm", q32, k32) * scale, bias)
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhnm,bnhd->bmhd", p, g32)
    dp = torch.einsum("bnhd,bmhd->bhnm", g32, v32)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k32) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q32) * scale
    grads = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if bias is None:
        return grads
    dbias = ds.view(-1, *bias.shape).sum(dim=0)
    return grads + (dbias.to(bias.dtype),)


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


def _bias_fn():
    lib = _build.load("flash_attention")
    fn = lib.windowed_attention_bias
    if fn.argtypes is None:
        fn.argtypes = BIAS_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_bias(q, bias) -> None:
    b, n, h, _ = q.shape
    if (bias.dim() != 4 or bias.shape[1:] != (h, n, n) or bias.shape[0] < 1
            or b % bias.shape[0]):
        raise ValueError(f"bias must be (G, H, N, N) = (G, {h}, {n}, {n}) with G dividing "
                         f"B = {b}, got {tuple(bias.shape)}")
    if bias.device != q.device:
        raise ValueError("the bias must be on q's device")


def bias_kernel_takes(q: torch.Tensor) -> bool:
    """Whether the biased kernel takes (B, N, H, D) ``q`` (and k, v like it):
    bfloat16 on a CUDA device, D in ``BIAS_HEAD_DIMS``, N <= ``BIAS_MAX_N``."""
    return (q.device.type == "cuda" and q.dtype == torch.bfloat16
            and q.shape[-1] in BIAS_HEAD_DIMS and q.shape[1] <= BIAS_MAX_N)


def _launch_inputs(q, k, v, bias=None):
    """The checks both kernels' wrappers share. → ``(result, None)``: the
    plain version's on the CPU, or the empty output where there is nothing
    to attend; else ``(out, ((q, k, v), strides))`` for a launch, with a
    copy of each view the kernel cannot read."""
    _check(q, k, v)
    if bias is not None:
        _check_bias(q, bias)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias), None
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:  # nothing to attend: no kernel
        return out, None
    return out, _kernel_views(q, bias, q, k, v)


def _kernel_views(q, bias, *ts):
    """Raise where no kernel takes the call (a device other than CUDA, a head
    dim, or with a bias a type or shape, that has no kernel); else → (views,
    strides): each of ``ts`` as it is or, where the kernel cannot read it, a
    copy, and their batch, token and head strides."""
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    if bias is None and q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes head dims {HEAD_DIMS}, got {q.shape[-1]}")
    if bias is not None and not bias_kernel_takes(q):
        raise ValueError(f"the biased attention kernel takes bfloat16 q, k, v, head dims "
                         f"{BIAS_HEAD_DIMS} and at most {BIAS_MAX_N} tokens, got {q.dtype}, "
                         f"D = {q.shape[-1]}, N = {q.shape[1]}")
    ts = tuple(t if _kernel_reads(t) else t.clone(memory_format=torch.contiguous_format)
               for t in ts)
    return ts, [s for t in ts for s in t.stride()[:3]]


def _forward(q, k, v) -> torch.Tensor:
    out, launch = _launch_inputs(q, k, v)
    if launch is None:
        return out
    (q, k, v), strides = launch
    b, n, h, d = q.shape
    status = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, b, n, h, d, _scale(d),
        int(q.dtype == torch.bfloat16), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_attention")
    flash_attention.launches += 1
    return out


def _forward_bias(q, k, v, bias) -> torch.Tensor:
    out, launch = _launch_inputs(q, k, v, bias)
    if launch is None:
        return out
    (q, k, v), strides = launch
    b, n, h, d = q.shape
    bias = bias.detach().to(torch.float32).contiguous()
    status = _bias_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, bias.data_ptr(), b, n, h, d,
        bias.shape[0], _scale(d), out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "windowed_attention_bias")
    flash_attention.bias_launches += 1
    return out


def _grad_fn(name: str, argtypes: list):
    fn = getattr(_build.load("attention_grad"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _grad_launch_inputs(q, k, v, g, bias=None):
    """The checks both backward wrappers share. → ``(grads, None)``: the
    plain version's on the CPU, or empty gradients where there is nothing
    to attend; else ``(grads, ((q, k, v, g), strides))`` for a launch into
    the allocated contiguous (dq, dk, dv)."""
    _check(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"the output's gradient must be {tuple(q.shape)} {q.dtype} on "
                         f"{q.device} as q, got {tuple(g.shape)} {g.dtype} on {g.device}")
    if bias is not None:
        _check_bias(q, bias)
    if q.device.type == "cpu":
        return attention_backward(q, k, v, g, bias), None
    grads = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    if q.numel() == 0:  # nothing attended: no kernel
        return grads + (() if bias is None else (torch.zeros_like(bias),)), None
    return grads, _kernel_views(q, bias, q, k, v, g)


def _backward(q, k, v, g):
    """→ (dq, dk, dv) of attention over (B, N, H, D) q, k, v for the output's
    gradient ``g``: two kernel launches on the card."""
    grads, launch = _grad_launch_inputs(q, k, v, g)
    if launch is not None:
        _launch_grad(*launch, grads)
    return grads


def _launch_grad(views, strides, grads) -> None:
    """Launch the unbiased backward over ``views`` (q, k, v, dO) into
    ``grads`` (dq, dk, dv) and count it."""
    q, k, v, g = views
    b, n, h, d = q.shape
    stats = torch.empty((2, b, h, n), dtype=torch.float32, device=q.device)  # lse, delta
    status = _grad_fn("attention_grad", GRAD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), *strides, b, n, h, d,
        _scale(d), int(q.dtype == torch.bfloat16), *(t.data_ptr() for t in grads),
        stats[0].data_ptr(), stats[1].data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "attention_grad")
    flash_attention.grad_launches += 1


def bias_grad_chunks(images: int, pairs: int) -> int:
    """Chunks of an image set the biased backward cuts each of its ``pairs``
    (window, head) pairs into: about ``BIAS_GRAD_BLOCKS`` blocks in all, each
    chunk ceil(images / chunks) images and none empty."""
    chunks = max(1, min(images, -(-BIAS_GRAD_BLOCKS // pairs)))
    return -(-images // -(-images // chunks))


def _backward_bias(q, k, v, g, bias):
    """→ (dq, dk, dv, dbias) of the biased attention: one kernel launch on
    the card, then its partials of dbias summed over the chunks."""
    grads, launch = _grad_launch_inputs(q, k, v, g, bias)
    if launch is None:
        return grads
    return grads + (_launch_bias_grad(*launch, bias, grads),)


def _launch_bias_grad(views, strides, bias, grads) -> torch.Tensor:
    """Launch the biased backward over ``views`` (q, k, v, dO) into
    ``grads`` (dq, dk, dv), count it, → dbias: its partials summed."""
    q, k, v, g = views
    b, n, h, d = q.shape
    groups = bias.shape[0]
    chunks = bias_grad_chunks(b // groups, groups * h)
    bias32 = bias.detach().to(torch.float32).contiguous()
    partial = torch.empty((chunks, groups, h, n, n), dtype=torch.float32, device=q.device)
    status = _grad_fn("windowed_attention_bias_grad", BIAS_GRAD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), *strides, bias32.data_ptr(),
        b, n, h, d, groups, chunks, _scale(d), *(t.data_ptr() for t in grads),
        partial.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "windowed_attention_bias_grad")
    flash_attention.bias_grad_launches += 1
    return partial.sum(dim=0).to(bias.dtype)


class _FlashAttention(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version) forward and backward;
    the backward recomputes P, as the JAX VJP's does. Saves q, k and v, not
    P."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return _backward(*ctx.saved_tensors, g)


class _FlashAttentionBias(torch.autograd.Function):
    """The biased kernel (or the plain version) forward; the recomputing
    backward with the bias's gradient. Saves q, k, v and the bias."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return _forward_bias(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        return _backward_bias(q, k, v, g, bias)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """Fused attention over (B, N, H, D) q, k, v → contiguous (B, N, H, D)
    in their dtype, differentiable; the counterpart of the JAX package's
    ``flash_attention`` (scale ``D^-1/2``; fold another scale into q). An
    optional (G, H, N, N) ``bias`` is added to batch row b's scaled scores
    as ``bias[b % G]`` (see the module note)."""
    if bias is None:
        return _FlashAttention.apply(q, k, v)
    return _FlashAttentionBias.apply(q, k, v, bias)


flash_attention.launches = 0
flash_attention.bias_launches = 0
flash_attention.grad_launches = 0
flash_attention.bias_grad_launches = 0
