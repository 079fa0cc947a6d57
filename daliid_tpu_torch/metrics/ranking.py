"""Market-protocol CMC / mAP ranking on the device, and the host oracle.

Port of ``daliid_tpu/metrics/ranking.py``: :func:`cosine_distance_matrix`
(``:32``), :func:`_positive_prologue` (``:44``), :func:`_counts_epilogue`
(``:65``), :func:`max_positives_bound` and :func:`positive_columns`
(``:318-359``, numpy, copied), :func:`evaluate_rank` (``evaluate_rank_jax``,
``:410-461``, with ``count_all`` and ``ignore_camera``) and
:func:`evaluate_rank_numpy` (``:744``, copied, the oracle).

The positive-slot bound P differs from the JAX package's on purpose:
:func:`evaluate_rank` takes :func:`queried_positives_bound`, the largest
gallery multiplicity of a pid that some query asks for, where the JAX
package takes :func:`max_positives_bound` over every gallery pid. On
Market-1501 that drops the 2,798 rows of distractor pid 0, which no query
asks for, from P = 2,800 to a few dozen. ``positive_columns`` refuses a
bound below a queried multiplicity, so no positive is dropped and the CMC
and mAP are the same.

Ranking is sort-free: each positive's kept rank is the count of kept
gallery entries before it in the stable (distance, gallery index) order,
computed by kernel K2 (``ops/rank_counts.py``) over the whole distance
matrix. The epilogue turns the exact integer counts into CMC rows and AP in
float64, chunked over queries. Ranks within a query are unique, so a
positive's rank among the query's positives is its place in the sorted
counts (an argsort) rather than the JAX package's (B, P, P) compare, which
grows with P squared. The CMC is exact; mAP agrees with the float64 oracle
to summation order (about 1e-16).

:func:`evaluate_rank_sharded` (``:464``) and
:func:`evaluate_rank_sharded_multihead` (``:528``, the per-pair head merge
of ``:686-744``) rank from raw embeddings without the whole (Q, G) matrix:
each rank of a gang (:mod:`daliid_tpu_torch.parallel.mesh`) takes its
block of the queries and ranks it ``query_chunk`` rows at a time through
K2 against the whole gallery, so a chunk's (``query_chunk``, G) distances
are the largest buffer; the CMC sums, AP sum and valid count merge with
one ``all_reduce``. P is :func:`queried_positives_bound` over the whole
query set (the JAX package's ``:509`` and ``:591`` take
``max_positives_bound``), so every rank launches K2 with the same P. On one
process the same code ranks in bounded memory.
"""

from __future__ import annotations

import numpy as np
import torch

from daliid_tpu_torch.ops.rank_counts import positive_rank_counts
from daliid_tpu_torch.parallel.mesh import all_reduce_, row_range

_INT32_MAX = 2 ** 31 - 1


def cosine_distance_matrix(query_fvs: torch.Tensor, gallery_fvs: torch.Tensor) -> torch.Tensor:
    """``1 - Q @ G.T`` over L2-normalized embeddings, in float32 (TF32 is off
    on the GPU, see ``device.py``)."""
    q = query_fvs / (torch.linalg.norm(query_fvs, dim=1, keepdim=True) + 1e-12)
    g = gallery_fvs / (torch.linalg.norm(gallery_fvs, dim=1, keepdim=True) + 1e-12)
    return 1.0 - q @ g.T


def _positive_prologue(dist, q_cols, q_camids, g_camids, ignore_camera: bool):
    """Gather each query's same-pid gallery columns (``q_cols``, -1 padded),
    drop the query-camera ("junk") ones unless ``ignore_camera``, and return
    ``(posmask, num_rel, p_dist, p_idx)`` with +inf / int32-max at invalid
    slots."""
    valid_col = q_cols >= 0
    safe = torch.where(valid_col, q_cols, torch.zeros_like(q_cols)).long()
    d_cols = torch.gather(dist, 1, safe)
    if ignore_camera:
        posmask = valid_col
    else:
        posmask = valid_col & (g_camids[safe] != q_camids[:, None])
    num_rel = posmask.sum(dim=1)
    p_dist = torch.where(posmask, d_cols, torch.full_like(d_cols, float("inf")))
    p_idx = torch.where(posmask, safe, torch.full_like(safe, _INT32_MAX)).to(torch.int32)
    return posmask, num_rel, p_dist, p_idx


def _counts_epilogue(counts, posmask, num_rel, G: int, max_rank: int):
    """Counts → (cmc_rows (B, max_rank), ap (B,), valid (B,)) in float64.
    First match = the least kept count over valid positives; a positive's
    precision is (its rank among the positives + 1) / (its count + 1)."""
    big = G + 1
    c_valid = torch.where(posmask, counts.long(), torch.full_like(counts, big, dtype=torch.long))
    first = torch.where(num_rel > 0, c_valid.min(dim=1).values, torch.full_like(num_rel, G))
    order = torch.argsort(c_valid, dim=1, stable=True)
    ranks = torch.arange(c_valid.shape[1], device=counts.device).expand_as(order)
    pos_rank = torch.empty_like(order).scatter_(1, order, ranks)
    precision = (pos_rank + 1).double() / (counts.double() + 1.0)
    ap = torch.where(posmask, precision, torch.zeros_like(precision)).sum(dim=1)
    ap = ap / num_rel.clamp(min=1).double()
    cmc_rows = (first[:, None] <= torch.arange(max_rank, device=counts.device)[None, :]).double()
    return cmc_rows, ap, num_rel > 0


def max_positives_bound(g_pids) -> int:
    """Static per-query positive-count bound: the largest gallery pid
    multiplicity, rounded up to 8."""
    gp = np.asarray(g_pids)
    if gp.size == 0:
        return 8
    counts = np.unique(gp, return_counts=True)[1]
    return int(min(gp.size, 8 * np.ceil(counts.max() / 8)))


def queried_positives_bound(q_pids, g_pids) -> int:
    """Per-query positive-count bound over the queried pids only: the
    largest gallery multiplicity of a pid in ``q_pids``, rounded up to 8,
    and at least 8."""
    qp, gp = np.asarray(q_pids), np.asarray(g_pids)
    uniq, counts = np.unique(gp, return_counts=True)
    queried = counts[np.isin(uniq, qp)]
    return int(8 * max(1, np.ceil(queried.max() / 8))) if queried.size else 8


def positive_columns(q_pids, g_pids, max_positives: int) -> np.ndarray:
    """(num_q, max_positives) int32 table of each query's same-pid gallery
    column indices (ascending), -1 padded; all -1 for queries whose pid is
    absent from the gallery."""
    qp = np.asarray(q_pids)
    gp = np.asarray(g_pids)
    if gp.size == 0 or qp.size == 0:
        return np.full((qp.shape[0], max_positives), -1, np.int32)
    order = np.argsort(gp, kind="stable")
    uniq, starts, counts = np.unique(gp[order], return_index=True, return_counts=True)
    width = int(counts.max())
    pid_table = np.full((uniq.shape[0], width), -1, np.int32)
    rows = np.repeat(np.arange(uniq.shape[0]), counts)
    slots = np.arange(gp.size) - np.repeat(starts, counts)
    pid_table[rows, slots] = order
    q_row = np.clip(np.searchsorted(uniq, qp), 0, uniq.shape[0] - 1)
    has = uniq[q_row] == qp
    q_mult = np.where(has, counts[q_row], 0)
    if q_mult.size and int(q_mult.max()) > max_positives:
        # truncating here would silently drop positives and miscount ranks
        raise ValueError(
            f"max_positives={max_positives} is below the largest queried-pid "
            f"gallery multiplicity ({int(q_mult.max())}); raise it or use the "
            "default bound"
        )
    out = np.full((qp.shape[0], max_positives), -1, np.int32)
    take = min(width, max_positives)
    out[:, :take] = np.where(has[:, None], pid_table[q_row][:, :take], -1)
    return out


def _ids(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int32) if not torch.is_tensor(x) else x,
                           dtype=torch.int32, device=device)


def evaluate_rank(distmat, q_pids, g_pids, q_camids, g_camids, max_rank: int = 50,
                  query_chunk: int = 512, max_positives: int | None = None,
                  count_all: bool = False, ignore_camera: bool = False):
    """Market-protocol CMC curve + mAP on ``distmat``'s device.

    → ``(cmc (max_rank,) float64 numpy, mAP float)``. Argument order mirrors
    torchreid's ``evaluate_rank(distmat, q_pids, g_pids, q_camids,
    g_camids)``. Queries whose every same-pid gallery entry shares their
    camera are excluded from both averages. ``ignore_camera`` drops the
    junk filter and ``count_all`` averages over every query (the BRIAR
    convention). ``max_positives`` defaults to :func:`queried_positives_bound`.
    The counting core is kernel K2 on a CUDA distmat."""
    if not torch.is_tensor(distmat):
        distmat = torch.as_tensor(np.asarray(distmat, np.float32))
    distmat = distmat.float()
    dev = distmat.device
    num_q, G = distmat.shape
    g_pids_np = np.asarray(g_pids.cpu() if torch.is_tensor(g_pids) else g_pids)
    q_pids_np = np.asarray(q_pids.cpu() if torch.is_tensor(q_pids) else q_pids)
    if max_positives is None:
        max_positives = queried_positives_bound(q_pids_np, g_pids_np)
    q_cols = torch.as_tensor(positive_columns(q_pids_np, g_pids_np, max_positives), device=dev)
    qp, qc = _ids(q_pids, dev), _ids(q_camids, dev)
    gp, gc = _ids(g_pids, dev), _ids(g_camids, dev)

    posmask, num_rel, p_dist, p_idx = _positive_prologue(distmat, q_cols, qc, gc, ignore_camera)
    counts = positive_rank_counts(distmat, p_dist, p_idx, qp, qc, gp, gc,
                                  ignore_camera=ignore_camera)
    cmc_sum = torch.zeros(max_rank, dtype=torch.float64, device=dev)
    ap_sum = torch.zeros((), dtype=torch.float64, device=dev)
    n_valid = torch.zeros((), dtype=torch.float64, device=dev)
    chunk = max(1, query_chunk)
    for s in range(0, num_q, chunk):
        cmc_rows, ap, valid = _counts_epilogue(
            counts[s:s + chunk], posmask[s:s + chunk], num_rel[s:s + chunk], G, max_rank)
        v = valid.double()
        cmc_sum += (cmc_rows * v[:, None]).sum(dim=0)
        ap_sum += (ap * v).sum()
        n_valid += v.sum()
    denom = float(num_q) if count_all else max(float(n_valid), 1.0)
    denom = max(denom, 1.0)
    return cmc_sum.cpu().numpy() / denom, float(ap_sum) / denom


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def _rows(x, device) -> torch.Tensor:
    """Embeddings (numpy or torch) as f32 rows on ``device``."""
    t = x.float() if torch.is_tensor(x) else torch.as_tensor(np.asarray(x, np.float32))
    return t.to(device)


def _normalized(x, device) -> torch.Tensor:
    """:func:`_rows`, L2-normalized as :func:`cosine_distance_matrix`
    normalizes them."""
    t = _rows(x, device)
    return t / (torch.linalg.norm(t, dim=1, keepdim=True) + 1e-12)


def _device_of(x, device):
    if device is not None:
        return torch.device(device)
    return x.device if torch.is_tensor(x) else torch.device("cpu")


def _rank_rows_sharded(rows_dist, num_q: int, q_pids, g_pids, q_camids, g_camids,
                       device, max_rank: int, count_all: bool, ignore_camera: bool,
                       query_chunk: int):
    """This rank's block of the queries, ``query_chunk`` rows at a time:
    ``rows_dist(a, b)`` gives the distances of queries [a, b) to the whole
    gallery; K2 counts each chunk; the sums merge over the gang."""
    qp_np, gp_np = _host(q_pids).astype(np.int32), _host(g_pids).astype(np.int32)
    qc_np = _host(q_camids).astype(np.int32)
    max_positives = queried_positives_bound(qp_np, gp_np)
    gp, gc = _ids(gp_np, device), _ids(g_camids, device)
    n_g = gp_np.shape[0]
    sums = torch.zeros(max_rank + 2, dtype=torch.float64, device=device)
    start, stop = row_range(num_q)
    cols = torch.as_tensor(positive_columns(qp_np[start:stop], gp_np, max_positives),
                           device=device)
    qp, qc = _ids(qp_np[start:stop], device), _ids(qc_np[start:stop], device)
    for a in range(0, stop - start, max(1, query_chunk)):
        b = min(a + max(1, query_chunk), stop - start)
        dist = rows_dist(start + a, start + b)
        posmask, num_rel, p_dist, p_idx = _positive_prologue(dist, cols[a:b], qc[a:b], gc,
                                                             ignore_camera)
        counts = positive_rank_counts(dist, p_dist, p_idx, qp[a:b], qc[a:b], gp, gc,
                                      ignore_camera=ignore_camera)
        cmc_rows, ap, valid = _counts_epilogue(counts, posmask, num_rel, n_g, max_rank)
        v = valid.double()
        sums[:max_rank] += (cmc_rows * v[:, None]).sum(dim=0)
        sums[max_rank] += (ap * v).sum()
        sums[max_rank + 1] += v.sum()
    all_reduce_(sums)
    sums = sums.cpu()
    denom = float(num_q) if count_all else float(sums[max_rank + 1])
    denom = max(denom, 1.0)
    return sums[:max_rank].numpy() / denom, float(sums[max_rank]) / denom


def evaluate_rank_sharded(query_fvs, gallery_fvs, q_pids, g_pids, q_camids, g_camids,
                          max_rank: int = 50, count_all: bool = False,
                          ignore_camera: bool = False, query_chunk: int = 512, device=None):
    """CMC (max_rank,) float64 and mAP from raw embeddings (normalized
    here) without the whole distance matrix: this rank's queries against
    the whole gallery, ``query_chunk`` rows at a time, merged over the gang.
    ``device`` defaults to the query tensor's (the CPU for numpy)."""
    dev = _device_of(query_fvs, device)
    q, g = _normalized(query_fvs, dev), _normalized(gallery_fvs, dev)
    return _rank_rows_sharded(lambda a, b: 1.0 - q[a:b] @ g.T, q.shape[0], q_pids, g_pids,
                              q_camids, g_camids, dev, max_rank, count_all, ignore_camera,
                              query_chunk)


def evaluate_rank_sharded_multihead(q_heads, g_heads, q_pids, g_pids, q_camids, g_camids,
                                    max_rank: int = 50, count_all: bool = False,
                                    ignore_camera: bool = False, query_chunk: int = 512,
                                    head_weighting: str = "mean", device=None):
    """:func:`evaluate_rank_sharded` of a multi-head ensemble: each chunk's
    distances are the heads' cosine distances merged per pair, their mean
    (``"mean"``) or weighted by the larger of the two raw-embedding norms
    (``"magnitude"``), so no per-head (Q, G) matrix exists either."""
    if head_weighting not in ("mean", "magnitude"):
        raise ValueError(f"head_weighting must be mean|magnitude, got {head_weighting!r}")
    if len(q_heads) != len(g_heads) or any(
            qh.shape[1] != gh.shape[1] for qh, gh in zip(q_heads, g_heads)):
        raise ValueError("query/gallery head dims differ")
    dev = _device_of(q_heads[0], device)
    qs, gs = [_normalized(h, dev) for h in q_heads], [_normalized(h, dev) for h in g_heads]
    q_mag = [torch.linalg.vector_norm(_rows(h, dev), dim=1) for h in q_heads]
    g_mag = [torch.linalg.vector_norm(_rows(h, dev), dim=1) for h in g_heads]

    def rows_dist(a, b):
        num, den = 0.0, 0.0
        for qh, gh, qm, gm in zip(qs, gs, q_mag, g_mag):
            d = 1.0 - qh[a:b] @ gh.T
            if head_weighting == "magnitude":
                w = torch.maximum(qm[a:b, None], gm[None, :])
                num, den = num + w * d, den + w
            else:
                num = num + d
        return num / (den if head_weighting == "magnitude" else float(len(qs)))

    return _rank_rows_sharded(rows_dist, qs[0].shape[0], q_pids, g_pids, q_camids, g_camids,
                              dev, max_rank, count_all, ignore_camera, query_chunk)


def evaluate_rank_numpy(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=50):
    """Pure-numpy per-query reference of the protocol (host scan, stable
    argsort), copied from the JAX package as the parity oracle."""
    distmat = np.asarray(distmat)
    q_pids = np.asarray(q_pids, dtype=np.int64)
    g_pids = np.asarray(g_pids, dtype=np.int64)
    q_camids = np.asarray(q_camids, dtype=np.int64)
    g_camids = np.asarray(g_camids, dtype=np.int64)

    num_q, num_g = distmat.shape
    order_all = np.argsort(distmat, axis=1, kind="stable")

    cmc_sum = np.zeros(max_rank, dtype=np.float64)
    ap_list = []
    for qi in range(num_q):
        order = order_all[qi]
        gp = g_pids[order]
        gc = g_camids[order]
        junk = (gp == q_pids[qi]) & (gc == q_camids[qi])
        raw = (gp == q_pids[qi])[~junk].astype(np.float64)
        num_rel = raw.sum()
        if num_rel == 0:
            continue
        csum = raw.cumsum()
        hit = np.minimum(csum, 1.0)
        cmc_sum += hit[:max_rank] if hit.shape[0] >= max_rank else np.pad(
            hit, (0, max_rank - hit.shape[0]), constant_values=hit[-1]
        )
        precision = csum / np.arange(1, raw.shape[0] + 1)
        ap_list.append(float((precision * raw).sum() / num_rel))

    num_valid = max(len(ap_list), 1)
    return cmc_sum / num_valid, float(np.mean(ap_list)) if ap_list else 0.0
