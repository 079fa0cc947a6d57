"""Gallery search top-k: the plain version and the CUDA kernel's wrapper.

Counterpart of ``daliid_tpu/ops/search_topk.py`` (``sq8_search_topk`` and
``f32_search_topk``, Pallas body ``_kernel``). For Q probes it returns the
top-k (k <= 64) probe . gallery similarities over the gallery's first
``num_real`` rows as ``(vals (Q, k) f32, idx (Q, k) int32)``:

- SQ8: int8 x int8 -> int32, times the gallery row's scale. The probe's own
  scale is rank-invariant and is applied by the caller
  (``eval/matcher.py``), as in the JAX package.
- f32: a plain dot.

Order: value descending, then gallery index ascending. Slots beyond
``num_real`` candidates are ``(-inf, -1)``.

Kernel note (``csrc/search_topk.cu``, replaces the TPU kernel above): pass 1
streams the gallery once per 64-probe tile, 128 rows at a time, through a
ring of shared-memory stages filled by 16-byte ``cp.async`` copies ahead of
the products, which run on the tensor cores: ``mma.sync`` s8 x s8 -> s32 in
SQ8 mode, and in f32 mode bf16 ``mma.sync`` on each element split exactly
into three bf16 pieces (six piece products, f32 sums). Each probe's top-k
stays in warp registers; pass 2 merges the per-chunk candidates. On the H100
the least time is the gallery's bytes over 3.35 TB/s in both modes: 0.64 ms
for 2^20 rows of 2048 int8, 2.56 ms in f32, where the six bf16 piece
products need 1.67 ms at 989 TFLOP/s (PERF.md has the times). The SQ8 score
is one rounded f32 multiply of an exact int32, so SQ8 is bit-exact against
:func:`search_topk_plain` and the JAX kernel; f32 agrees to summation order
(the dropped piece products are below 2^-23 of each product). Ties order by
gallery index, as the TPU kernel's first-lane argmax does. The TPU kernel's
``< 2^24``-row cap, ``MAX_PROBES`` and f32-encoded index lane are gone.

On a CPU tensor the wrappers compute the plain version; on a CUDA tensor
they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from daliid_tpu_torch.ops import _build

MAX_K = 64
# gallery rows per kernel tile: a chunk is a whole number of them
_TILE = 128
# the plain version sorts at most this many gallery rows at a time
_PLAIN_ROWS = 1 << 16


def search_topk_plain(q, g, num_real: int, k: int, g_scale=None):
    """The same function in plain PyTorch (any device). SQ8 when ``q`` and
    ``g`` are int8 (``g_scale`` then required), f32 otherwise.

    SQ8 products are taken in float64, where every int8 dot over D <= 2^17
    is an exact integer, then rounded to f32 and scaled as the kernel does.
    The gallery is walked in blocks of rows; a stable descending sort keeps
    ties in index order, so block results merge exactly."""
    quantized = q.dtype == torch.int8
    n_q = q.shape[0]
    vals = torch.full((n_q, 0), float("-inf"), dtype=torch.float32, device=q.device)
    idx = torch.zeros((n_q, 0), dtype=torch.int64, device=q.device)
    qw = q.double() if quantized else q
    for r0 in range(0, num_real, _PLAIN_ROWS):
        r1 = min(r0 + _PLAIN_ROWS, num_real)
        if quantized:
            sims = (qw @ g[r0:r1].double().T).float() * g_scale[r0:r1]
        else:
            sims = q @ g[r0:r1].T
        v, i = torch.sort(sims, dim=1, descending=True, stable=True)
        vals = torch.cat([vals, v[:, :k]], dim=1)
        idx = torch.cat([idx, i[:, :k] + r0], dim=1)
        v, order = torch.sort(vals, dim=1, descending=True, stable=True)
        vals, idx = v[:, :k], torch.gather(idx, 1, order)[:, :k]
    pad = k - vals.shape[1]
    if pad > 0:
        vals = torch.cat([vals, vals.new_full((n_q, pad), float("-inf"))], dim=1)
        idx = torch.cat([idx, idx.new_full((n_q, pad), -1)], dim=1)
    return vals.contiguous(), idx.to(torch.int32).contiguous()


def _check(q, g, g_scale, num_real: int, k: int, dtype) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"search_topk takes 1 <= k <= {MAX_K}; got k={k}")
    if q.dim() != 2 or g.dim() != 2 or q.shape[1] != g.shape[1]:
        raise ValueError(f"probe {tuple(q.shape)} and gallery {tuple(g.shape)} "
                         "must be (Q, D) and (G, D)")
    if q.dtype != dtype or g.dtype != dtype:
        raise TypeError(f"expected {dtype} probe and gallery, got {q.dtype}, {g.dtype}")
    if g_scale is not None and (g_scale.dtype != torch.float32
                                or g_scale.shape != (g.shape[0],)):
        raise ValueError(f"g_scale must be (G,) float32, got {g_scale.dtype} "
                         f"{tuple(g_scale.shape)}")
    if not 0 <= num_real <= g.shape[0]:
        raise ValueError(f"num_real={num_real} outside [0, {g.shape[0]}]")
    devices = {q.device, g.device} | ({g_scale.device} if g_scale is not None else set())
    if len(devices) != 1:
        raise ValueError("probe, gallery and scales must be on one device")


def _fn():
    lib = _build.load("search_topk")
    fn = lib.search_topk
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
    return fn


def _launch(q, g, g_scale, num_real: int, k: int, wrapper):
    """Run the kernel for ``wrapper`` and add one to its count; an input with
    no probes or no real gallery rows needs no kernel and counts nothing."""
    quantized = g_scale is not None
    n_q = q.shape[0]
    if n_q == 0 or num_real == 0:
        return (torch.full((n_q, k), float("-inf"), dtype=torch.float32, device=q.device),
                torch.full((n_q, k), -1, dtype=torch.int32, device=q.device))
    if q.device.type != "cuda":
        raise RuntimeError(f"search_topk runs on CUDA or CPU tensors, got {q.device}")
    q, g = q.contiguous(), g.contiguous()
    g_scale = g_scale.contiguous() if quantized else None
    d = q.shape[1]
    vals = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
    # about four chunks per SM, each a whole number of gallery tiles
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    rows = -(-num_real // (4 * sms))
    rows = max(_TILE, -(-rows // _TILE) * _TILE)
    n_chunks = -(-num_real // rows)
    cand_v = torch.empty((n_q, n_chunks, k), dtype=torch.float32, device=q.device)
    cand_i = torch.empty((n_q, n_chunks, k), dtype=torch.int32, device=q.device)
    status = _fn()(
        q.data_ptr(), g.data_ptr(), g_scale.data_ptr() if quantized else None, n_q, d,
        num_real, k, rows, int(quantized), cand_v.data_ptr(), cand_i.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "search_topk")
    wrapper.launches += 1
    return vals, idx


def sq8_search_topk(q8, g8, g_scale, num_real: int, k: int):
    """→ (vals (Q, k) f32, idx (Q, k) int32): top-k of ``(float)(q8 . g8[j])
    * g_scale[j]`` over ``g8``'s first ``num_real`` rows."""
    num_real = int(num_real)
    _check(q8, g8, g_scale, num_real, k, torch.int8)
    if q8.device.type == "cpu":
        return search_topk_plain(q8, g8, num_real, k, g_scale)
    return _launch(q8, g8, g_scale, num_real, k, sq8_search_topk)


def f32_search_topk(q, g, num_real: int, k: int):
    """f32 mode: → (vals, idx) like :func:`sq8_search_topk`, scores ``q .
    g[j]`` over an f32 gallery."""
    num_real = int(num_real)
    _check(q, g, None, num_real, k, torch.float32)
    if q.device.type == "cpu":
        return search_topk_plain(q, g, num_real, k)
    return _launch(q, g, None, num_real, k, f32_search_topk)


sq8_search_topk.launches = 0
f32_search_topk.launches = 0
