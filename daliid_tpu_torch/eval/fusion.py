"""Clean + distorted model fusion, the DaliID paper's test-time method.

Port of ``daliid_tpu/eval/fusion.py``: the feature concatenation ensemble,
the distance-matrix average, the magnitude-weighted fusion (each image's
raw embedding norm under a pooling as its quality; per (query, gallery)
pair the larger of the two norms weighs each model's distance) and the ROC
arrays. The matrix functions take tensors and work on their device.

:func:`roc_curve` is a numpy copy of ``sklearn.metrics.roc_curve`` at its
defaults (``pos_label=1``, ``drop_intermediate=True``; the first threshold
is ``inf``, as in scikit-learn 1.3 and later), which the JAX CLI imports
for its ROC dump; the port does not depend on scikit-learn.
"""

from __future__ import annotations

import numpy as np
import torch

from daliid_tpu_torch.metrics.ranking import cosine_distance_matrix


def concat_features_distmat(q_fvs_a, q_fvs_b, g_fvs_a, g_fvs_b) -> torch.Tensor:
    """Concatenate two models' embeddings → cosine distmat (each row is
    normalized after the concatenation)."""
    return cosine_distance_matrix(torch.cat([q_fvs_a, q_fvs_b], dim=1),
                                  torch.cat([g_fvs_a, g_fvs_b], dim=1))


def average_distmats(*distmats) -> torch.Tensor:
    """Uniform mean of distance matrices."""
    return torch.stack(distmats).mean(dim=0)


def magnitude_weights(fvs: torch.Tensor) -> torch.Tensor:
    """(N, 1) L2 norm of each *raw* (unnormalized) embedding, extracted with
    the pooling whose magnitude is wanted."""
    return torch.linalg.vector_norm(fvs, dim=1, keepdim=True)


def magnitude_weighted_distmat(distmat_a, distmat_b, q_mag_a, g_mag_a, q_mag_b,
                               g_mag_b) -> torch.Tensor:
    """``w_m[i, j] = max(q_mag_m[i], g_mag_m[j])`` for each model m, then
    ``(w_a * d_a + w_b * d_b) / (w_a + w_b)``."""
    w_a = torch.maximum(q_mag_a.reshape(-1, 1), g_mag_a.reshape(1, -1))
    w_b = torch.maximum(q_mag_b.reshape(-1, 1), g_mag_b.reshape(1, -1))
    return (w_a * distmat_a + w_b * distmat_b) / (w_a + w_b)


def roc_arrays(distmat, q_pids, g_pids):
    """(labels, scores) over all (query, gallery) pairs as numpy: label =
    same identity, score = ``1 - dist / 2``."""
    labels = (np.asarray(q_pids).reshape(-1, 1) == np.asarray(g_pids).reshape(1, -1))
    dist = distmat.cpu().numpy() if torch.is_tensor(distmat) else np.asarray(distmat)
    return labels.astype(np.int32).ravel(), (1.0 - dist / 2.0).ravel()


def roc_curve(labels, scores):
    """→ (fpr, tpr, thresholds) as ``sklearn.metrics.roc_curve(labels,
    scores, pos_label=1)`` returns them: one point per distinct score in
    descending order, collinear points dropped, (0, 0) at threshold ``inf``
    first; fpr (tpr) is NaN when there is no negative (positive)."""
    y = (np.asarray(labels).ravel() == 1).astype(np.float64)
    s = np.asarray(scores).ravel()
    order = np.argsort(s, kind="stable")[::-1]
    s, y = s[order], y[order]
    thr_idx = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y)[thr_idx]
    fps = 1.0 + thr_idx - tps
    thresholds = s[thr_idx].astype(np.float64)
    if fps.shape[0] > 2:
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds
