"""Positive rank counts: the plain version and the CUDA kernel's wrapper.

Counterpart of ``daliid_tpu/ops/rank_counts.py::positive_rank_counts``
(Pallas body ``_kernel``). For every query q and positive slot p it counts
the gallery columns j that come before the positive in the Market
protocol's stable order (distance, then gallery index):

    kd[q, j] < p_dist[q, p]  or  (kd[q, j] == p_dist[q, p] and j < p_idx[q, p])

where kd is the distance with junk entries (same pid and same camid as the
query) set to +inf; ``ignore_camera`` turns the junk mask off. Distances
must be finite, as a cosine distance matrix is. Invalid slots
(``p_dist == +inf``) count 0 here, where the JAX kernel leaves garbage that
its caller masks.

Kernel note (``csrc/rank_counts.cu``, replaces the TPU kernel above): on
the H100 the least time is the bytes, the distmat's 4 * Q * G once over
3.35 TB/s (0.065 ms at the Market-1501 shape, Q=3368, G=15913). The kernel
does work per valid positive, not per padded slot: one block per query
sorts the query's valid slots in shared memory (rank by counting), builds
a lookup table of distance buckets between the least and largest key, then
its warps stream the distmat row once with 16-byte loads and put each
column in the bin of the sorted keys at or before it (the table, plus a
compare with the key of its own bucket; a column past the largest key is
skipped). A scan of the gallery pids takes the junk columns back out of
their bins, and a prefix sum of the bins gives each positive's count,
exact in any order of the additions, written once. A query with more valid
slots than one pass holds takes them in passes over its row. The TPU
kernel's transposed layout and +inf row padding are not carried over.

On a CPU tensor :func:`positive_rank_counts` computes the plain version; on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from daliid_tpu_torch.ops import _build

# the plain version compares at most this many (query, column, slot) triples at once
_PLAIN_BLOCK = 1 << 24


def rank_counts_plain(dist, p_dist, p_idx, q_pids, q_camids, g_pids, g_camids,
                      ignore_camera: bool = False):
    """The same function in plain PyTorch (any device), in blocks of
    queries and gallery columns."""
    n_q, n_g = dist.shape
    n_p = p_dist.shape[1]
    counts = torch.zeros((n_q, n_p), dtype=torch.int32, device=dist.device)
    if n_q == 0 or n_g == 0 or n_p == 0:
        return counts
    if ignore_camera:
        kd = dist
    else:
        junk = (g_pids[None, :] == q_pids[:, None]) & (g_camids[None, :] == q_camids[:, None])
        kd = torch.where(junk, torch.full_like(dist, float("inf")), dist)
    g_blk = max(1, min(n_g, _PLAIN_BLOCK // max(n_p, 1)))
    q_blk = max(1, _PLAIN_BLOCK // (g_blk * max(n_p, 1)))
    cols = torch.arange(n_g, dtype=torch.int64, device=dist.device)
    for q0 in range(0, n_q, q_blk):
        t = p_dist[q0:q0 + q_blk, None, :]
        pi = p_idx[q0:q0 + q_blk, None, :].long()
        for g0 in range(0, n_g, g_blk):
            d = kd[q0:q0 + q_blk, g0:g0 + g_blk, None]
            j = cols[None, g0:g0 + g_blk, None]
            before = (d < t) | ((d == t) & (j < pi))
            counts[q0:q0 + q_blk] += before.sum(dim=1, dtype=torch.int32)
    return torch.where(p_dist == float("inf"), torch.zeros_like(counts), counts)


def _fn():
    lib = _build.load("rank_counts")
    fn = lib.rank_counts
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


def positive_rank_counts(dist, p_dist, p_idx, q_pids, q_camids, g_pids, g_camids,
                         ignore_camera: bool = False):
    """→ counts (Q, P) int32 of kept gallery entries before each positive.

    ``dist`` (Q, G) f32; ``p_dist`` (Q, P) f32 (+inf at invalid slots);
    ``p_idx`` (Q, P) int32; pids and camids int32."""
    n_q, n_g = dist.shape
    n_p = p_dist.shape[1] if p_dist.dim() == 2 else -1
    if dist.dtype != torch.float32 or p_dist.dtype != torch.float32:
        raise TypeError("dist and p_dist must be float32")
    if p_dist.shape != (n_q, n_p) or p_idx.shape != (n_q, n_p):
        raise ValueError(f"p_dist {tuple(p_dist.shape)} / p_idx {tuple(p_idx.shape)} "
                         f"must be (Q, P) with Q = {n_q}")
    ids = (p_idx, q_pids, q_camids, g_pids, g_camids)
    if any(t.dtype != torch.int32 for t in ids):
        raise TypeError("p_idx, pids and camids must be int32")
    if q_pids.shape != (n_q,) or q_camids.shape != (n_q,) \
            or g_pids.shape != (n_g,) or g_camids.shape != (n_g,):
        raise ValueError("pids / camids must be (Q,) and (G,)")
    if len({t.device for t in (dist, p_dist) + ids}) != 1:
        raise ValueError("all inputs must be on one device")
    if dist.device.type == "cpu":
        return rank_counts_plain(dist, p_dist, p_idx, q_pids, q_camids, g_pids,
                                 g_camids, ignore_camera)
    if n_q == 0 or n_g == 0 or n_p == 0:  # nothing to count: no kernel
        return torch.zeros((n_q, n_p), dtype=torch.int32, device=dist.device)
    if dist.device.type != "cuda":
        raise RuntimeError(f"positive_rank_counts runs on CUDA or CPU tensors, got {dist.device}")
    args = [t.contiguous() for t in (dist, p_dist) + ids]
    out = torch.empty((n_q, n_p), dtype=torch.int32, device=dist.device)
    status = _fn()(
        *[t.data_ptr() for t in args], n_q, n_g, n_p, int(ignore_camera),
        out.data_ptr(), torch.cuda.current_stream(dist.device).cuda_stream,
    )
    _build.check(status, "rank_counts")
    positive_rank_counts.launches += 1
    return out


positive_rank_counts.launches = 0
