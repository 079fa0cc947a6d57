"""Market-1501's ranking protocol, written out plainly.

Cosine distance ``1 - q . g`` of L2-normalized embeddings (``x / (||x|| +
1e-12)``), computed in ``dtype`` over the whole query-by-gallery matrix at
once; per query the gallery in ascending (distance, gallery index) order,
without the entries of its own identity taken by its own camera (junk); the
CMC counts whether a true match is within the first r, and the AP, in
float64, averages the precision at each true match. Queries without a true
match outside their camera are left out of both averages.
"""

from __future__ import annotations

import numpy as np
import torch


def evaluate(q_fvs, g_fvs, q_pids, g_pids, q_cams, g_cams, max_rank: int = 50,
             device="cpu", dtype=torch.float32, chunk: int = 256) -> tuple:
    """→ (cmc (max_rank,) float64 numpy, mAP, the number of queries
    averaged)."""
    q = torch.as_tensor(np.asarray(q_fvs), device=device).to(dtype)
    g = torch.as_tensor(np.asarray(g_fvs), device=device).to(dtype)
    q = q / (torch.linalg.norm(q, dim=1, keepdim=True) + 1e-12)
    g = g / (torch.linalg.norm(g, dim=1, keepdim=True) + 1e-12)
    dist = 1.0 - q @ g.T
    qp, qc = (torch.as_tensor(np.asarray(a), device=device) for a in (q_pids, q_cams))
    gp, gc = (torch.as_tensor(np.asarray(a), device=device) for a in (g_pids, g_cams))
    cmc = torch.zeros(max_rank, dtype=torch.float64, device=device)
    ap_sum, n_valid = 0.0, 0
    for s in range(0, len(q), chunk):
        order = torch.sort(dist[s:s + chunk], dim=1, stable=True).indices
        match = gp[order] == qp[s:s + chunk, None]
        keep = ~(match & (gc[order] == qc[s:s + chunk, None]))
        # each kept entry's place among the kept; junk goes past the end
        pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1,
                          torch.full_like(order, order.shape[1] - 1))
        hits = torch.zeros(order.shape, dtype=torch.float64, device=device)
        hits.scatter_(1, pos, (match & keep).double())
        num_rel = hits.sum(dim=1)
        valid = num_rel > 0
        csum = torch.cumsum(hits, dim=1)
        cmc += (csum[:, :max_rank].clamp(max=1.0) * valid[:, None]).sum(dim=0)
        ranks = torch.arange(1, hits.shape[1] + 1, device=device, dtype=torch.float64)
        ap = (csum / ranks * hits).sum(dim=1) / num_rel.clamp(min=1.0)
        ap_sum += float((ap * valid).sum())
        n_valid += int(valid.sum())
    n = max(n_valid, 1)
    return (cmc / n).cpu().numpy(), ap_sum / n, n_valid
