"""k-reciprocal re-ranking (Zhong et al., CVPR'17) on the caller's device.

Port of ``daliid_tpu/eval/rerank.py``: :func:`re_ranking` (``:100-120``),
the evaluation step the reference carries commented out
(``validateModels.py:49-53``), and :func:`rerank_shortlists` (``:82-97``),
its batched per-probe form for the serving path. The results are the JAX
package's within float32 rounding: the same neighbour sets, tie for tie,
and the same arithmetic on them, laid out so that no (chunk, N, N) tensor
exists (a literal copy of the JAX Jaccard step would build 190 GB at
Market-1501's N = 19,281):

- the k-NN sets are prefixes of ONE stable ascending sort of each row
  (``stable=True``, as ``jnp.argsort``): synthetic galleries hold exact
  duplicates, so ties are real and must break by column index;
- the reciprocal sets R(i) and R_half(j) are dense boolean masks; the
  2/3-overlap test counts, for each candidate j in the k1 + 1 nearest of
  i, the members of R_half(j) that lie in R(i) (a gather of at most
  ``k1 // 2 + 1`` entries), where the JAX package multiplies two 0/1
  (N, N) matrices; the counts are the same integers, compared as
  ``overlap >= float32(2/3) * |R_half(j)|`` in float32 as there;
- the local query expansion (the JAX ``(knn2 / k2) @ v``) adds the k2
  nearest rows of v, each times ``float32(1) / k2``: a gather of k2 rows
  per row instead of an (N, N) @ (N, N) product;
- the Jaccard sum ``sum_k min(v_ik, v_jk)`` over v >= 0 runs only over
  the columns where query row i is nonzero (the others add exactly 0):
  chunks of query rows gather those columns (as rows of v transposed),
  padded with zero weights, and reduce them, in chunks of at most
  ``2**28`` elements (a batch of shortlists reduces over every column, so
  that a probe's answer does not depend on the other probes in its batch).

Everything runs on the device that the inputs live on and returns a
tensor there; numpy inputs run on the CPU.
"""

from __future__ import annotations

import torch

# elements of the largest temporary of one Jaccard or sort chunk (1 GiB of f32)
_CHUNK_ELEMS = 1 << 28


def _stable_order(dist: torch.Tensor, k: int) -> torch.Tensor:
    """(B, n, n) → (B, n, k) int64: the first ``k`` columns of each row's
    stable ascending order (ties by column index), sorted in row chunks."""
    bsz, n, _ = dist.shape
    rows = max(1, _CHUNK_ELEMS // (2 * bsz * n))  # f32 values + int64 indices a chunk
    return torch.cat([torch.sort(dist[:, s:s + rows], dim=-1, stable=True).indices[..., :k]
                      for s in range(0, n, rows)], dim=1)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a batched (B, n, m) tensor: ``out[b, ...] = x[b, idx[b, ...]]``
    → idx.shape + (m,)."""
    bsz, n, m = x.shape
    off = torch.arange(bsz, device=x.device).view(bsz, *([1] * (idx.dim() - 1))) * n
    return x.reshape(bsz * n, m).index_select(0, (idx + off).reshape(-1)).view(*idx.shape, m)


def _dense_mask(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n, k) column indices, ``n`` meaning none → (B, n, n) bool."""
    bsz, rows, _ = idx.shape
    mask = torch.zeros(bsz, rows, n + 1, dtype=torch.bool, device=idx.device)
    return mask.scatter_(2, idx, True)[..., :n]


def _rerank_core(original: torch.Tensor, num_q: int, k1: int, k2: int,
                 lambda_value: float) -> torch.Tensor:
    """(B, n, n) distances, the first ``num_q`` rows and columns the
    queries → (B, num_q, n - num_q) re-ranked query-gallery distances."""
    bsz, n, _ = original.shape
    dev = original.device
    # symmetrize as the standard implementation does
    dist = torch.minimum(original, original.transpose(1, 2))
    a, h, c2 = min(k1 + 1, n), min(k1 // 2 + 1, n), min(k2, n)
    order = _stable_order(dist, max(a, c2))
    nn1, nh, nn2 = order[..., :a], order[..., :h], order[..., :c2]

    knn1 = _dense_mask(nn1, n)
    recip = knn1 & knn1.transpose(1, 2)  # R(i): mutual k1 + 1 nearest
    del knn1
    knnh = _dense_mask(nh, n)
    rhalf = knnh & knnh.transpose(1, 2)  # R_half(j): mutual k1 // 2 + 1 nearest
    del knnh
    r_valid = recip.gather(2, nn1)       # (B, n, a): nn1[i, t] in R(i)
    h_valid = rhalf.gather(2, nh)        # (B, n, h): nh[j, s] in R_half(j)
    del rhalf
    sizes = h_valid.sum(-1).float()      # |R_half(j)|

    # cluster expansion: for each candidate j = nn1[i, t] in R(i), add
    # R_half(j) when |R(i) ∩ R_half(j)| >= 2/3 |R_half(j)|
    j = nn1.reshape(bsz, n * a)
    cand = _rows(nh, j).view(bsz, n, a, h)
    cand_valid = _rows(h_valid, j).view(bsz, n, a, h)
    in_r = recip.gather(2, cand.view(bsz, n, a * h)).view(bsz, n, a, h)
    overlap = (in_r & cand_valid).sum(-1).float()
    two_thirds = torch.tensor(2.0 / 3.0, dtype=torch.float32, device=dev)
    expand = r_valid & (overlap >= two_thirds * sizes.gather(1, j).view(bsz, n, a))
    added = torch.where(expand[..., None] & cand_valid, cand, n).view(bsz, n, a * h)
    expanded = _dense_mask(added, n) | recip
    del recip, cand, cand_valid, in_r, added

    # Gaussian-weighted membership, L1-normalized per row
    v = torch.where(expanded, torch.exp(-dist), 0.0)
    del expanded, dist
    v = v / v.sum(-1, keepdim=True).clamp_min(1e-12)

    # local query expansion: the mean of the k2 nearest rows (JAX's
    # mask / k2 weights, float32(1) / k2 each), renormalized
    weight = torch.tensor(1.0, dtype=torch.float32, device=dev) / k2
    v2 = torch.zeros_like(v)
    for t in range(c2):
        v2 += weight * _rows(v, nn2[..., t])
    del v
    v2 = v2 / v2.sum(-1, keepdim=True).clamp_min(1e-12)

    # Jaccard of each query row against every row: rows sum to 1, so
    # jac = 1 - min_sum / (2 - min_sum), min_sum over query i's support
    vq = v2[:, :num_q]
    # a batch of instances reduces over all n columns, so that each
    # instance's sums do not depend on its batchmates' supports
    s_max = n if bsz > 1 else max(1, int((vq > 0).sum(-1).max()))
    vt = v2.transpose(1, 2).contiguous()  # vt[b, k] = column k of v2
    del v2
    step = max(1, _CHUNK_ELEMS // (bsz * s_max * n))
    jaccard = torch.empty(bsz, num_q, n, dtype=torch.float32, device=dev)
    for q0 in range(0, num_q, step):
        vals, cols = torch.topk(vq[:, q0:q0 + step], s_max, dim=-1)  # the support, then zeros
        g = _rows(vt, cols)  # (B, c, s_max, n)
        min_sum = torch.minimum(g, vals[..., None], out=g).sum(2)
        jaccard[:, q0:q0 + step] = 1.0 - min_sum / (2.0 - min_sum)
    final = (1.0 - lambda_value) * jaccard + lambda_value * original[:, :num_q]
    return final[:, :, num_q:]


def rerank_shortlists(fulls: torch.Tensor, k1: int, k2: int,
                      lambda_value: float) -> torch.Tensor:
    """Batched per-probe re-ranking for the serving path: ``fulls`` (Q,
    1 + depth, 1 + depth) distance matrices, row and column 0 the probe and
    the rest its shortlist → (Q, depth) re-ranked distances. Each probe is
    an independent one-query instance."""
    return _rerank_core(fulls.float(), 1, k1, k2, float(lambda_value))[:, 0, :]


def re_ranking(distmat_qg, distmat_qq, distmat_gg, k1: int = 20, k2: int = 6,
               lambda_value: float = 0.3) -> torch.Tensor:
    """→ the re-ranked (Q, G) distance matrix on the inputs' device (the
    query-gallery matrix's; numpy runs on the CPU). The signature of the
    torchreid call the reference comments out (``validateModels.py:49-53``):
    the query-gallery, query-query and gallery-gallery distance matrices."""
    qg = torch.as_tensor(distmat_qg, dtype=torch.float32)
    qq = torch.as_tensor(distmat_qq, dtype=torch.float32, device=qg.device)
    gg = torch.as_tensor(distmat_gg, dtype=torch.float32, device=qg.device)
    full = torch.cat([torch.cat([qq, qg], dim=1), torch.cat([qg.T, gg], dim=1)], dim=0)
    return _rerank_core(full[None], qq.shape[0], k1, k2, float(lambda_value))[0]
