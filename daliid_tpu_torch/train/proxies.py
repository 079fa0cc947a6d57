"""Per-class proxy mining: farthest-point selection + class centers.

Copy of ``daliid_tpu/train/proxies.py`` (``:28-127``), numpy on the host,
with :func:`mine_camera_centers` (``:52-67``) for ``losses.camera_hard_loss``.

Re-implements the reference's epoch-level proxy mining
(``Person-ReID/train_encodersKIT.py:103-156``):

- embed the whole train set with the online model
  (``train_encodersKIT.py:110``, done by the caller);
- per class: greedy max-min farthest-point selection of ``num_proxies``
  samples (``selectProxiesByTriagulation``, ``train_encodersKIT.py:252-284``)
  starting from a random seed sample;
- class center = mean embedding (``train_encodersKIT.py:133``);
- L2-normalize centers and proxies (``train_encodersKIT.py:137-143``);
- diagnostics: mean max intra-class proxy distance and min inter-class proxy
  distance (``train_encodersKIT.py:147-156``).

Runs on host numpy: ~C small (n_c x n_c) distance problems once per epoch
(microseconds each) — not worth a device round-trip. Proxies are padded to
``num_proxies`` per class with label -1 so downstream shapes are static.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def select_proxies_farthest_point(X: np.ndarray, num_proxies: int, rng: np.random.Generator):
    """Greedy max-min (farthest-point) selection over one class's embeddings.

    Matches ``selectProxiesByTriagulation`` (``train_encodersKIT.py:252-284``):
    seed with a random sample; repeatedly add the point maximizing the
    minimum distance to the already-chosen set. Returns (indices,
    max_pairwise_distance_among_proxies).
    """
    n = X.shape[0]
    num_proxies = min(num_proxies, n)
    d2 = np.maximum(
        np.sum(X * X, axis=1)[:, None] + np.sum(X * X, axis=1)[None, :] - 2.0 * (X @ X.T), 0.0
    )
    dist = np.sqrt(d2)
    chosen = [int(rng.integers(n))]
    min_dist = np.full(n, dist.max())
    for _ in range(num_proxies - 1):
        min_dist = np.minimum(min_dist, dist[chosen[-1]])
        chosen.append(int(np.argmax(min_dist)))
    idx = np.asarray(chosen)
    max_dist = float(dist[np.ix_(idx, idx)].max())
    return idx, max_dist


def mine_camera_centers(features: np.ndarray, class_indices: np.ndarray, camera_ids: np.ndarray):
    """Per-(identity, camera) centers for the camera-proxy loss
    (:func:`daliid_tpu_torch.losses.camera_hard_loss`; the reference builds
    these outside ``BatchCameraHardLoss``, consumed at ``losses.py:794-866``).

    Returns (centers (M, D) L2-normalized, center_ids (M,), center_cams (M,)).
    """
    keys = np.stack([class_indices, camera_ids], axis=1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    d = features.shape[1]
    centers = np.zeros((len(uniq), d), np.float32)
    np.add.at(centers, inv, features)
    counts = np.bincount(inv, minlength=len(uniq)).astype(np.float32)
    centers /= counts[:, None]
    centers /= np.linalg.norm(centers, axis=1, keepdims=True) + 1e-12
    return centers, uniq[:, 0].astype(np.int32), uniq[:, 1].astype(np.int32)


class ProxySet(NamedTuple):
    centers: np.ndarray          # (C, D) L2-normalized, ordered by class index
    proxies: np.ndarray          # (C * num_proxies, D) L2-normalized, padded
    proxy_labels: np.ndarray     # (C * num_proxies,) int32; -1 on padding
    mean_max_intra: float        # mean over classes of max intra-proxy distance
    min_inter: float             # min distance between proxies of different classes


def mine_proxies_and_centers(
    features: np.ndarray,
    class_indices: np.ndarray,
    num_classes: int,
    num_proxies: int = 5,
    rng: np.random.Generator | None = None,
) -> ProxySet:
    """Centers + farthest-point proxies for every class (fixed-shape output).

    ``num_proxies=5`` matches the trainer default (``train_encodersKIT.py:61``).
    """
    rng = rng or np.random.default_rng(12)
    D = features.shape[1]
    centers = np.zeros((num_classes, D), np.float32)
    proxies = np.zeros((num_classes * num_proxies, D), np.float32)
    proxy_labels = -np.ones(num_classes * num_proxies, np.int32)
    mean_max = 0.0

    for c in range(num_classes):
        X = features[class_indices == c]
        if len(X) == 0:
            continue
        idx, max_d = select_proxies_farthest_point(X, num_proxies, rng)
        mean_max += max_d
        centers[c] = X.mean(axis=0)
        sel = X[idx]
        proxies[c * num_proxies : c * num_proxies + len(idx)] = sel
        proxy_labels[c * num_proxies : c * num_proxies + len(idx)] = c

    centers /= np.linalg.norm(centers, axis=1, keepdims=True) + 1e-12
    valid = proxy_labels >= 0
    proxies[valid] /= np.linalg.norm(proxies[valid], axis=1, keepdims=True) + 1e-12

    # min inter-class proxy distance diagnostic (train_encodersKIT.py:147-156)
    pv = proxies[valid]
    lv = proxy_labels[valid]
    d2 = np.maximum(
        np.sum(pv * pv, 1)[:, None] + np.sum(pv * pv, 1)[None, :] - 2.0 * (pv @ pv.T), 0.0
    )
    dist = np.sqrt(d2)
    inter = lv[:, None] != lv[None, :]
    min_inter = float(dist[inter].min()) if inter.any() else 0.0

    return ProxySet(
        centers=centers,
        proxies=proxies,
        proxy_labels=proxy_labels,
        mean_max_intra=mean_max / max(num_classes, 1),
        min_inter=min_inter,
    )
