"""DaliID's per-epoch proxy mining, written out plainly
(``Person-ReID/train_encodersKIT.py:103-156, 252-284``).

For each class in order: pick ``num_proxies`` embeddings by greedy max-min
(farthest-point) selection from a random first one, drawn from the miner's
PCG64 stream; the class center is the mean embedding; centers and proxies
are L2-normalized. Proxies are padded to ``num_proxies`` a class with label
-1.
"""

from __future__ import annotations

import numpy as np


def mine(features: np.ndarray, class_idx: np.ndarray, num_classes: int, num_proxies: int,
         rng: np.random.Generator):
    """→ (centers (C, D), proxies (C * num_proxies, D), proxy labels)."""
    d = features.shape[1]
    centers = np.zeros((num_classes, d), np.float32)
    proxies = np.zeros((num_classes * num_proxies, d), np.float32)
    labels = -np.ones(num_classes * num_proxies, np.int32)
    for c in range(num_classes):
        x = features[class_idx == c]
        if len(x) == 0:
            continue
        sq = np.sum(x * x, axis=1)
        dist = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0))
        chosen = [int(rng.integers(len(x)))]
        nearest = np.full(len(x), dist.max())
        for _ in range(min(num_proxies, len(x)) - 1):
            nearest = np.minimum(nearest, dist[chosen[-1]])
            chosen.append(int(np.argmax(nearest)))
        centers[c] = x.mean(axis=0)
        lo = c * num_proxies
        proxies[lo:lo + len(chosen)] = x[chosen]
        labels[lo:lo + len(chosen)] = c
    centers /= np.linalg.norm(centers, axis=1, keepdims=True) + 1e-12
    ok = labels >= 0
    proxies[ok] /= np.linalg.norm(proxies[ok], axis=1, keepdims=True) + 1e-12
    return centers, proxies, labels
