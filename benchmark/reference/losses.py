"""DaliID's batch losses on L2-normalized embeddings, written out plainly.

From the reference's ``losses.py``: each sample is weighted by its
distortion level through a cosine schedule over the epochs (6 levels for
the center and proxy losses, 13 for the cross entropy and the triplet), and
masked padding slots weigh nothing.

- center loss: ``-log softmax(f . centers^T / tau)[label]``;
- proxy loss: per sample with ``k`` own-class proxies, against its ``k``
  most similar other-class proxies,
  ``-mean_j log(exp(s_pos_j / tau) / (sum exp(s_pos / tau) + sum exp(s_neg / tau)))``;
- cross entropy over the softmax of a classifier's logits;
- softmax triplet: ``softplus((hardest negative - hardest positive) / tau)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

N_MIN_6 = (1.0, 0.8, 0.6, 0.4, 0.2, 0.1)
N_MIN_13 = (1.0, 0.90, 0.85, 0.80, 0.75, 0.70, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1, 0.1)


def level_weights(levels, epoch: int, num_epochs: int, n_mins, mask) -> torch.Tensor:
    """Each sample's weight: ``n_min + (1 - n_min) (1 + cos(pi (T - t) / T)) / 2``
    of its level, 0 on padding."""
    c = 0.5 * (1.0 + math.cos(math.pi * (num_epochs - epoch) / num_epochs))
    table = torch.tensor([n + (1.0 - n) * c for n in n_mins], device=levels.device)
    return table[levels.long()] * mask.float()


def _weighted_mean(w, per):
    return (w * per).sum() / w.sum().clamp_min(1e-9)


def center_loss(f, labels, levels, mask, centers, epoch, num_epochs, tau):
    w = level_weights(levels, epoch, num_epochs, N_MIN_6, mask)
    logp = torch.log_softmax(f @ centers.T / tau, dim=1)
    return _weighted_mean(w, -logp[torch.arange(len(f), device=f.device), labels.long()])


def proxy_loss(f, labels, levels, mask, proxies, proxy_labels, epoch, num_epochs, tau):
    w = level_weights(levels, epoch, num_epochs, N_MIN_6, mask)
    sim = f @ proxies.T / tau
    per = torch.zeros(len(f), device=f.device)
    has = torch.zeros(len(f), dtype=torch.bool, device=f.device)
    valid = proxy_labels >= 0
    for i in range(len(f)):
        pos = sim[i][valid & (proxy_labels == labels[i])]
        k = pos.numel()
        if k == 0:
            continue
        neg = sim[i][valid & (proxy_labels != labels[i])].topk(k).values
        denom = torch.log(pos.exp().sum() + neg.exp().sum() + 1e-9)
        per[i] = -(pos - denom).mean()
        has[i] = True
    return _weighted_mean(w * has.float(), per)


def cross_entropy(logits, labels, levels, mask, epoch, num_epochs):
    w = level_weights(levels, epoch, num_epochs, N_MIN_13, mask)
    p = torch.softmax(logits, dim=1)[torch.arange(len(logits), device=logits.device),
                                      labels.long()]
    return _weighted_mean(w, -torch.log(p + 1e-9))


def softmax_triplet(f, labels, levels, mask, epoch, num_epochs, tau):
    w = level_weights(levels, epoch, num_epochs, N_MIN_13, mask)
    sim = f @ f.T
    both = mask[:, None] & mask[None, :]
    same = (labels[:, None] == labels[None, :]) & both
    other = (labels[:, None] != labels[None, :]) & both
    p = torch.where(same, sim, torch.full_like(sim, math.inf)).amin(dim=1)
    q = torch.where(other, sim, torch.full_like(sim, -math.inf)).amax(dim=1)
    found = torch.isfinite(p) & torch.isfinite(q)
    per = torch.where(found, F.softplus(torch.where(found, q - p, torch.zeros_like(p)) / tau),
                      torch.zeros_like(p))
    return _weighted_mean(w, per)
