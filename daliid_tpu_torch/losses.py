"""The training slice's losses: cosine-scheduled, distortion-weighted batch
losses on L2-normalized embeddings.

Port of the part of ``daliid_tpu/losses.py`` that the train steps use:
:data:`N_MIN_6` and :data:`N_MIN_13` (``:26-29``),
:func:`cosine_schedule_value` and :func:`distortion_weights` (``:34-48``),
:func:`weighted_center_loss` (``:70-120``), :func:`weighted_proxy_loss`
(``:169-232``), :func:`weighted_cross_entropy_loss` (``:257-268``),
:func:`paired_distortion_loss` (``:271-288``) and, for the JPM branches,
:func:`softmax_triplet_loss` and :func:`weighted_softmax_triplet_loss`
(``:291-327``). Shapes
stay fixed: ragged per-class proxy counts are padded with label -1 and
masked, and ``sample_mask`` marks the padding slots of a PK batch. Masked
``-inf`` slots go through ``torch.where``, so their gradients are zero, not
NaN. Everything stays on the device: no value is fetched to the host.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# n_min ramps for the 6-level distortion weight table (losses.py:42-47)
N_MIN_6 = (1.0, 0.8, 0.6, 0.4, 0.2, 0.1)
# n_min ramps for the 13-level table (losses.py:92-104)
N_MIN_13 = (1.0, 0.90, 0.85, 0.80, 0.75, 0.70, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1, 0.1)

_EPS = 1e-9


def cosine_schedule_value(t_cur, t_max, n_min=0.0, n_max=1.0):
    """``n_min + 0.5 (n_max - n_min) (1 + cos(pi (t_max - t_cur) / t_max))``
    (``getValueFromCosineSchedule``, ``losses.py:5-7``): ``n_min`` at
    ``t_cur = 0``, ``n_max`` at ``t_cur = t_max``. Tensors or numbers."""
    return n_min + 0.5 * (n_max - n_min) * (1.0 + torch.cos(((t_max - t_cur) / t_max) * math.pi))


def distortion_weights(epoch, num_epochs, n_mins=N_MIN_6, device=None) -> torch.Tensor:
    """Per-distortion-level f32 weight vector at ``epoch``."""
    n = torch.tensor(n_mins, dtype=torch.float32, device=device)
    t = torch.as_tensor(epoch, dtype=torch.float32, device=device)
    return cosine_schedule_value(t, float(num_epochs), n_min=n, n_max=1.0)


def _weights_for(samples_distortion, epoch, num_epochs, n_mins):
    return distortion_weights(epoch, num_epochs, n_mins, samples_distortion.device)[
        samples_distortion.long()]


def _mask_or_ones(sample_mask, n: int, device) -> torch.Tensor:
    if sample_mask is None:
        return torch.ones(n, dtype=torch.bool, device=device)
    return sample_mask.bool()


def weighted_center_loss(batch_fvs, batch_labels, samples_distortion, centers, epoch,
                         num_epochs: float, tau: float = 0.1, sample_mask=None):
    """Distortion-weighted softmax-over-centers cross entropy
    (``BatchWeightedCenterLoss``, ``losses.py:39-88``): weight ``w_i`` from
    the 6-level table, ``p = softmax(fv . centers^T / tau)``, loss
    ``sum_i w_i (-log p_{i, y_i}) / sum_i w_i``. ``batch_labels`` are dense
    center indices.

    → ``(loss, aux)``, aux = dict(predicted, avg_max_prob, batch_acc_bal):
    the balanced accuracy is ``getACCBal`` (``losses.py:190-203``) on the
    device, per-class recall over the ground-truth classes divided by the
    size of the union of ground-truth and predicted classes."""
    n = batch_fvs.shape[0]
    mask = _mask_or_ones(sample_mask, n, batch_fvs.device)
    maskf = mask.float()
    labels = batch_labels.long()
    w = _weights_for(samples_distortion, epoch, num_epochs, N_MIN_6) * maskf
    sim = batch_fvs @ centers.T
    log_probs = torch.log_softmax(sim / tau, dim=1)
    nll = -log_probs.gather(1, labels[:, None])[:, 0]
    loss = (w * nll).sum() / w.sum().clamp_min(_EPS)

    with torch.no_grad():
        predicted = log_probs.argmax(dim=1)
        correct = ((predicted == labels) & mask).float()
        num_classes = centers.shape[0]
        zeros = torch.zeros(num_classes, dtype=torch.float32, device=batch_fvs.device)
        per_class_correct = zeros.index_add(0, labels, correct)
        per_class_count = zeros.index_add(0, labels, maskf)
        present_gt = per_class_count > 0
        present_pred = zeros.index_add(0, predicted, maskf) > 0
        recall = torch.where(present_gt, per_class_correct / per_class_count.clamp_min(1.0),
                             torch.zeros_like(per_class_count))
        acc_bal = recall.sum() / (present_gt | present_pred).sum().clamp_min(1)
        max_prob = log_probs.max(dim=1).values.exp()
        avg_max_prob = (max_prob * maskf).sum() / maskf.sum().clamp_min(1)
    return loss, {"predicted": predicted, "avg_max_prob": avg_max_prob,
                  "batch_acc_bal": acc_bal}


def weighted_proxy_loss(batch_fvs, batch_labels, samples_distortion, proxies, proxy_labels,
                        epoch, num_epochs: float, tau: float = 0.1, sample_mask=None,
                        p_max: int | None = None):
    """Distortion-weighted hard-negative proxy softmax
    (``BatchWeightedProxyLoss``, ``losses.py:273-341``). Per sample ``i``
    with ``k_i`` own-class proxies, the ``k_i`` most similar negative
    proxies; ``loss_i = -mean_j log[exp(s_pos_j / tau) / (sum exp(s_pos / tau)
    + sum exp(s_negtop / tau))]`` and ``loss = sum w_i loss_i / sum w_i`` over
    the samples that have a positive. ``p_max`` is the static bound on
    ``k_i`` (the trainer passes its ``num_proxies``); without it the bound is
    ``min(Np, 64)`` and a class owning more proxies than that raises."""
    n = batch_fvs.shape[0]
    mask = _mask_or_ones(sample_mask, n, batch_fvs.device)
    w = _weights_for(samples_distortion, epoch, num_epochs, N_MIN_6) * mask.float()
    labels = batch_labels.long()[:, None]
    plabels = proxy_labels.long()[None, :]
    sim = batch_fvs @ proxies.T  # (B, Np)
    is_pos = (plabels == labels) & (plabels >= 0)
    is_neg = (plabels != labels) & (plabels >= 0)
    num_pos = is_pos.sum(dim=1)
    if p_max is None:
        p_max = min(int(proxy_labels.shape[0]), 64)
        valid = proxy_labels[proxy_labels >= 0]
        if valid.numel() and int(torch.bincount(valid.long()).max()) > p_max:
            raise ValueError(f"a class owns more proxies than the static positive bound "
                             f"{p_max}: pass p_max (the trainer forwards num_proxies)")
    neg_inf = torch.full_like(sim, float("-inf"))
    pos_top = torch.topk(torch.where(is_pos, sim, neg_inf), p_max, dim=1).values
    neg_top = torch.topk(torch.where(is_neg, sim, neg_inf), p_max, dim=1).values

    slot = torch.arange(p_max, device=sim.device)[None, :]
    valid = slot < num_pos[:, None]  # the reference keeps exactly k_i negatives
    zero = torch.zeros_like(pos_top)
    pos_exp = torch.where(valid, torch.exp(pos_top / tau), zero)
    neg_exp = torch.where(valid, torch.exp(neg_top / tau), zero)
    denom = pos_exp.sum(dim=1, keepdim=True) + neg_exp.sum(dim=1, keepdim=True)
    log_ratio = torch.where(valid, pos_top / tau - torch.log(denom + _EPS), zero)
    per_sample = -log_ratio.sum(dim=1) / num_pos.clamp_min(1)
    w = w * (num_pos > 0)
    return (w * per_sample).sum() / w.sum().clamp_min(_EPS)


def paired_distortion_loss(clean_fvs, distorted_fvs, distortion_levels, epoch, num_epochs,
                           pair_mask=None):
    """Clean-distorted embedding consistency: the 13-level-weighted mean of
    per-pair squared L2 distances, normalized by the summed weights
    (``losses.py:90-148`` with the PK pairer's identity pairing)."""
    w = _weights_for(distortion_levels, epoch, num_epochs, N_MIN_13)
    if pair_mask is not None:
        w = w * pair_mask.float()
    d2 = ((clean_fvs - distorted_fvs) ** 2).sum(dim=1)
    return (w * d2).sum() / w.sum().clamp_min(_EPS)


def weighted_cross_entropy_loss(probs, labels, samples_distortion, epoch, num_epochs,
                                sample_mask=None):
    """Distortion-weighted cross entropy over classifier probabilities
    (``BatchWeightedCrossEntropyLoss``, ``losses.py:152-187``): 13-level
    weights, ``sum_i w_i (-log(p_{i, y_i} + 1e-9)) / sum_i w_i``.
    → ``(loss, mean max probability)``."""
    w = _weights_for(samples_distortion, epoch, num_epochs, N_MIN_13)
    if sample_mask is not None:
        w = w * sample_mask.float()
    nll = -torch.log(probs.gather(1, labels.long()[:, None])[:, 0] + _EPS)
    loss = (w * nll).sum() / w.sum().clamp_min(_EPS)
    return loss, probs.max(dim=1).values.mean()


def _pairwise_masks(batch_labels, sample_mask):
    same = batch_labels[:, None] == batch_labels[None, :]
    valid = sample_mask[:, None] & sample_mask[None, :]
    return same & valid, (~same) & valid


def _hardest_softplus(batch_fvs, batch_labels, mask, tau):
    """Per anchor: p = the least similar positive (itself included), q =
    the most similar negative, ``softplus((q - p) / tau)``
    (= ``-log(e^{p/tau} / (e^{p/tau} + e^{q/tau}))``); → (per-anchor loss,
    whether both exist). Anchors without either score 0 with a zero
    gradient."""
    sim = batch_fvs @ batch_fvs.T
    pos_mask, neg_mask = _pairwise_masks(batch_labels, mask)
    p = torch.where(pos_mask, sim, torch.full_like(sim, float("inf"))).amin(dim=1)
    q = torch.where(neg_mask, sim, torch.full_like(sim, float("-inf"))).amax(dim=1)
    found = torch.isfinite(p) & torch.isfinite(q)
    gap = torch.where(found, q - p, torch.zeros_like(p))
    return torch.where(found, F.softplus(gap / tau), torch.zeros_like(p)), found


def softmax_triplet_loss(batch_fvs, batch_labels, tau=0.1, sample_mask=None):
    """Hardest-positive/hardest-negative softmax triplet
    (``BatchSoftmaxTripletLoss``, ``losses.py:343-382``), averaged over the
    valid slots."""
    mask = _mask_or_ones(sample_mask, batch_fvs.shape[0], batch_fvs.device)
    per, found = _hardest_softplus(batch_fvs, batch_labels, mask, tau)
    per = torch.where(found & mask, per, torch.zeros_like(per))
    return per.sum() / mask.sum().clamp_min(1)


def weighted_softmax_triplet_loss(batch_fvs, batch_labels, samples_distortion, epoch,
                                  num_epochs, tau=0.1, sample_mask=None):
    """Distortion-weighted hardest triplet (``BatchWeightedSoftmaxTripletLoss``,
    ``losses.py:607-654``): 13-level weights, normalized by their sum."""
    mask = _mask_or_ones(sample_mask, batch_fvs.shape[0], batch_fvs.device)
    w = _weights_for(samples_distortion, epoch, num_epochs, N_MIN_13) * mask.float()
    per, _ = _hardest_softplus(batch_fvs, batch_labels, mask, tau)
    return (w * per).sum() / w.sum().clamp_min(_EPS)
