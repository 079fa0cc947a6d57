"""The loss library: cosine-scheduled, distortion-weighted batch losses on
L2-normalized embeddings.

Port of ``daliid_tpu/losses.py``. The train steps use
:data:`N_MIN_6` and :data:`N_MIN_13` (``:26-29``),
:func:`cosine_schedule_value` and :func:`distortion_weights` (``:34-48``),
:func:`weighted_center_loss` (``:70-120``), :func:`weighted_proxy_loss`
(``:169-232``), :func:`weighted_cross_entropy_loss` (``:257-268``),
:func:`paired_distortion_loss` (``:271-288``) and, for the JPM branches,
:func:`softmax_triplet_loss` and :func:`weighted_softmax_triplet_loss`
(``:291-327``); below them is the rest of the library, which no CLI's
train step takes (``:51``, ``:123-141``, ``:235-254``, ``:330-628``).
Shapes stay fixed: ragged per-class proxy counts are padded with label -1
and masked, and ``sample_mask`` marks the padding slots of a PK batch.
Masked ``-inf`` slots go through ``torch.where``, so their gradients are
zero, not NaN. Everything but :func:`balanced_accuracy_host` (numpy) stays
on the device: no value is fetched to the host.
"""

from __future__ import annotations

import math

import numpy as np
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


# ------------------------------------------------------------ the rest of the library
# Losses of ``daliid_tpu/losses.py`` that no train step of the CLIs takes
# (``:51``, ``:123-141``, ``:235-254``, ``:330-628``), for callers that
# compose their own objective. ``jax.nn.softplus`` is ``logaddexp(x, 0)``,
# kept as such (``F.softplus`` switches to ``x`` above its threshold);
# masked minima and maxima use ``amin`` / ``amax``, whose gradient, like
# JAX's, splits evenly over ties.

def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _inf_like(x, sign=1.0):
    return torch.full_like(x, sign * float("inf"))


def _wnorm(w, per):
    return (w * per).sum() / w.sum().clamp_min(_EPS)


def balanced_accuracy_host(predicted_labels, gt_labels) -> float:
    """Host-side balanced accuracy over the union of label sets (copy of
    the JAX ``:51-65``, ``getACCBal``, ``losses.py:190-203``)."""
    import numpy as np

    predicted_labels = np.asarray(predicted_labels)
    gt_labels = np.asarray(gt_labels)
    all_labels = np.union1d(np.unique(predicted_labels), np.unique(gt_labels))
    n = len(all_labels)
    p_idx = np.searchsorted(all_labels, predicted_labels)
    g_idx = np.searchsorted(all_labels, gt_labels)
    cm = np.zeros((n, n))
    np.add.at(cm, (g_idx, p_idx), 1.0)
    cm_rel = cm / (cm.sum(axis=1, keepdims=False)[:, None] + 1e-7)
    return float(np.trace(cm_rel) / n)


def center_loss(batch_fvs, batch_labels, centers, tau=0.1, sample_mask=None):
    """Unweighted softmax-over-centers cross entropy, mean over the valid
    samples (``BatchCenterLoss``, ``losses.py:9-37``)."""
    mask = _mask_or_ones(sample_mask, batch_fvs.shape[0], batch_fvs.device).float()
    log_probs = torch.log_softmax(batch_fvs @ centers.T / tau, dim=1)
    nll = -log_probs.gather(1, batch_labels.long()[:, None])[:, 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1)


def l2_center_loss(batch_fvs, batch_labels, centers, sample_mask=None):
    """Mean squared L2 distance to the own center (``BatchL2CenterLoss``,
    ``losses.py:206-236``)."""
    mask = _mask_or_ones(sample_mask, batch_fvs.shape[0], batch_fvs.device).float()
    d2 = ((batch_fvs - centers[batch_labels.long()]) ** 2).sum(dim=1)
    return (d2 * mask).sum() / mask.sum().clamp_min(1)


def proxy_loss(batch_fvs, batch_labels, proxies, proxy_labels, top_negs=50, tau=0.1,
               p_max=None):
    """Unweighted proxy softmax against the ``top_negs`` hardest negative
    proxies (``BatchProxyLoss``, ``losses.py:238-270``); ``p_max`` as in
    :func:`weighted_proxy_loss`."""
    labels = batch_labels.long()[:, None]
    plabels = proxy_labels.long()[None, :]
    sim = batch_fvs @ proxies.T
    is_pos = (plabels == labels) & (plabels >= 0)
    is_neg = (plabels != labels) & (plabels >= 0)
    num_pos = is_pos.sum(dim=1)
    if p_max is None:
        p_max = min(int(proxy_labels.shape[0]), 64)
        valid = proxy_labels[proxy_labels >= 0]
        if valid.numel() and int(torch.bincount(valid.long()).max()) > p_max:
            raise ValueError(f"a class owns more proxies than the static positive bound "
                             f"{p_max}: pass p_max")
    pos_top = torch.topk(torch.where(is_pos, sim, _inf_like(sim, -1.0)), p_max, dim=1).values
    neg_top = torch.topk(torch.where(is_neg, sim, _inf_like(sim, -1.0)),
                         min(top_negs, proxies.shape[0]), dim=1).values
    slot = torch.arange(p_max, device=sim.device)[None, :]
    pos_valid = slot < num_pos[:, None]
    pos_exp = torch.where(pos_valid, torch.exp(pos_top / tau), torch.zeros_like(pos_top))
    neg_exp = torch.where(torch.isfinite(neg_top), torch.exp(neg_top / tau),
                          torch.zeros_like(neg_top))
    denom = pos_exp.sum(1, keepdim=True) + neg_exp.sum(1, keepdim=True)
    log_ratio = torch.where(pos_valid, pos_top / tau - torch.log(denom + _EPS),
                            torch.zeros_like(pos_top))
    return (-log_ratio.sum(dim=1) / num_pos.clamp_min(1)).mean()


def weighted_softmax_all_triplet_loss(batch_fvs, batch_labels, samples_distortion, epoch,
                                      num_epochs, sample_mask=None):
    """Circle-style soft all-pair triplet (``BatchWeightedSoftmaxAllTripletLoss``,
    ``losses.py:656-691``): distance ``(1 - S) / 2`` softly re-weighted
    within positives and negatives, ``softplus(pos - neg)``, 6-level
    weights."""
    mask = _mask_or_ones(sample_mask, batch_fvs.shape[0], batch_fvs.device)
    w = _weights_for(samples_distortion, epoch, num_epochs, N_MIN_6) * mask.float()
    dist = 1.0 - (batch_fvs @ batch_fvs.T + 1.0) / 2.0
    pos_mask, neg_mask = _pairwise_masks(batch_labels, mask)
    pos_d = torch.exp(dist) * pos_mask
    neg_d = torch.exp(-dist) * neg_mask
    pos_w = pos_d / (pos_d.sum(dim=1, keepdim=True) + _EPS)
    neg_w = neg_d / (neg_d.sum(dim=1, keepdim=True) + _EPS)
    per = _softplus((pos_w * dist).sum(dim=1) - (neg_w * dist).sum(dim=1))
    return _wnorm(w, per)


def weighted_all_positive_cosine_loss(batch_fvs, batch_labels, samples_distortion, epoch,
                                      num_epochs, sample_mask=None):
    """Mean cosine distance to the same-class samples, self excluded from
    the count, 6-level weights (``BatchWeightedSoftmaxAllCosineLoss``,
    ``losses.py:693-728``)."""
    mask = _mask_or_ones(sample_mask, batch_fvs.shape[0], batch_fvs.device)
    w = _weights_for(samples_distortion, epoch, num_epochs, N_MIN_6) * mask.float()
    pos_mask, _ = _pairwise_masks(batch_labels, mask)
    num_pos = pos_mask.sum(dim=1) - 1
    per = ((1.0 - batch_fvs @ batch_fvs.T) * pos_mask).sum(dim=1) / num_pos.clamp_min(1)
    return _wnorm(w, per)


def softmax_all_triplet_loss(batch_fvs, batch_labels, samples_distortion, epoch, num_epochs,
                             tau=0.1, sample_mask=None):
    """All-positive relative softmax against the summed negatives
    (``BatchSoftmaxAllTripletLoss``, ``losses.py:419-464``), weighted by the
    first six ramps of the 13-level table (its override at ``:437``)."""
    mask = _mask_or_ones(sample_mask, batch_fvs.shape[0], batch_fvs.device)
    w = _weights_for(samples_distortion, epoch, num_epochs, N_MIN_13[:6]) * mask.float()
    s_exp = torch.exp(batch_fvs @ batch_fvs.T / tau)
    pos_mask, neg_mask = _pairwise_masks(batch_labels, mask)
    neg_sum = (s_exp * neg_mask).sum(dim=1, keepdim=True)
    rel = -torch.log(s_exp / (s_exp + neg_sum) + _EPS) * pos_mask
    per = rel.sum(dim=1) / pos_mask.sum(dim=1).clamp_min(1)
    return _wnorm(w, per)


def multi_level_distortion_loss(batch_fvs, distorted_fvs):
    """Mean cosine distance from each clean embedding to its five distorted
    copies (``BatchDistortionLoss``, ``losses.py:868-883``): ``distorted_fvs``
    holds 6 rows a sample, [clean, level 1..5]."""
    n = batch_fvs.shape[0]
    groups = distorted_fvs.reshape(n, 6, -1)[:, 1:, :]
    return (1.0 - torch.einsum("nd,nkd->nk", batch_fvs, groups)).mean()


def instance_loss(batch_fvs):
    """Cosine distance between the two views at even and odd slots
    (``BatchInstanceLoss``, ``losses.py:885-894``)."""
    return (1.0 - (batch_fvs[::2] * batch_fvs[1::2]).sum(dim=1)).mean()


def hard_center_triplet_loss(batch_fvs, batch_labels, centers, tau=0.1, sample_mask=None):
    """Hardest-center triplet: p = the similarity to the own center, q = the
    largest over the other centers (``BatchHardSoftmaxTripletLoss``,
    ``losses.py:896-925``)."""
    mask = _mask_or_ones(sample_mask, batch_fvs.shape[0], batch_fvs.device)
    sim = batch_fvs @ centers.T
    own = F.one_hot(batch_labels.long(), centers.shape[0]).bool()
    p = torch.where(own, sim, _inf_like(sim)).amin(dim=1)
    q = torch.where(~own, sim, _inf_like(sim, -1.0)).amax(dim=1)
    per = torch.where(mask, _softplus((q - p) / tau), torch.zeros_like(p))
    return per.sum() / mask.sum().clamp_min(1)


def clothes_triplet_loss(batch_fvs, batch_labels, batch_clothes, tau=0.1, sample_mask=None):
    """Clothes-changing triplet: the hardest same-identity
    different-clothes positive against the hardest negative
    (``BatchSoftmaxClothesTripletLoss``, ``losses.py:384-417``); anchors
    without such a positive are skipped."""
    mask = _mask_or_ones(sample_mask, batch_fvs.shape[0], batch_fvs.device)
    sim = batch_fvs @ batch_fvs.T
    valid = mask[:, None] & mask[None, :]
    same_id = (batch_labels[:, None] == batch_labels[None, :]) & valid
    pos_mask = same_id & (batch_clothes[:, None] != batch_clothes[None, :])
    neg_mask = (~same_id) & valid
    p = torch.where(pos_mask, sim, _inf_like(sim)).amin(dim=1)
    q = torch.where(neg_mask, sim, _inf_like(sim, -1.0)).amax(dim=1)
    ok = mask & torch.isfinite(p) & torch.isfinite(q)
    per = torch.where(ok, _softplus((q - p) / tau), torch.zeros_like(p))
    return per.sum() / ok.sum().clamp_min(1)


def _partition_loss(s_exp, w, pos_mask, neg_mask):
    pos_sum = (s_exp * pos_mask).sum(dim=1, keepdim=True)
    neg_sum = (s_exp * neg_mask).sum(dim=1, keepdim=True)
    rel = -torch.log((s_exp * pos_mask + _EPS) / (pos_sum + neg_sum + _EPS)) * pos_mask
    per = rel.sum(dim=1) / (pos_mask.sum(dim=1) + _EPS)
    return _wnorm(w, per)


def bipartite_loss(batch_fvs, batch_labels, batch_cameras, batch_clothes, samples_distortion,
                   epoch, num_epochs, tau=0.1, sample_mask=None, controlled=None):
    """Clothes- and camera-partitioned relative softmax pair
    (``BatchSoftmaxBipatiteLoss``, ``losses.py:467-547``), 13-level weights;
    → ``(clothes_loss, camera_loss)``. Clothes: positives same identity,
    same camera, other clothes; negatives other identities on the same
    camera. Camera: the cross-setup pairs of ``controlled`` (a per-sample
    bool; all False empties the branch, as a batch with no 'controlled'
    camera does in the reference)."""
    n = batch_fvs.shape[0]
    mask = _mask_or_ones(sample_mask, n, batch_fvs.device)
    if controlled is None:
        controlled = torch.zeros(n, dtype=torch.bool, device=batch_fvs.device)
    controlled = controlled.bool()
    w = _weights_for(samples_distortion, epoch, num_epochs, N_MIN_13) * mask.float()
    s_exp = torch.exp(batch_fvs @ batch_fvs.T / tau)
    valid = mask[:, None] & mask[None, :]
    same_id = (batch_labels[:, None] == batch_labels[None, :]) & valid
    same_cam = batch_cameras[:, None] == batch_cameras[None, :]
    same_clothes = batch_clothes[:, None] == batch_clothes[None, :]
    cross_setup = (controlled[None, :] == ~controlled[:, None]) & valid
    clothes = _partition_loss(s_exp, w, same_id & same_cam & ~same_clothes,
                              (~same_id) & valid & same_cam)
    camera = _partition_loss(s_exp, w, same_id & cross_setup, (~same_id) & valid & cross_setup)
    return clothes, camera


def weighted_pose_loss(batch_fvs, batch_labels, batch_cameras, batch_clothes,
                       samples_distortion, epoch, num_epochs, tau=0.1, sample_mask=None):
    """Pose partition: positives of the same identity, clothes and camera
    (``BatchWeightedPoseLoss``, ``losses.py:549-605``), 13-level weights."""
    mask = _mask_or_ones(sample_mask, batch_fvs.shape[0], batch_fvs.device)
    w = _weights_for(samples_distortion, epoch, num_epochs, N_MIN_13) * mask.float()
    s_exp = torch.exp(batch_fvs @ batch_fvs.T / tau)
    valid = mask[:, None] & mask[None, :]
    same_id = (batch_labels[:, None] == batch_labels[None, :]) & valid
    same_cam = batch_cameras[:, None] == batch_cameras[None, :]
    same_clothes = batch_clothes[:, None] == batch_clothes[None, :]
    return _partition_loss(s_exp, w, same_id & same_clothes & same_cam,
                           ~same_id & same_cam & valid)


def _sorted_desc(sim, keep):
    """Each row's kept similarities in descending order, -inf after them."""
    return -torch.sort(torch.where(keep, -sim, _inf_like(sim)), dim=1, stable=True).values


def controlled_camera_hard_loss(batch_fvs, batch_labels, samples_distortion, epoch, num_epochs,
                                tau=0.1, sample_mask=None):
    """Clean anchor → per-distortion-level hardest triplets
    (``BatchControlledCameraHardLoss``, ``losses.py:730-791``): for each
    clean anchor and each level d = 1..5 present in its class, p = the least
    similar same-class level-d sample, q = the k-th most similar clean
    negative, k = the number of lower levels present; 13-level weights of
    the level."""
    n = batch_fvs.shape[0]
    mask = _mask_or_ones(sample_mask, n, batch_fvs.device)
    sim = batch_fvs @ batch_fvs.T
    valid = mask[:, None] & mask[None, :]
    same_id = (batch_labels[:, None] == batch_labels[None, :]) & valid
    table = distortion_weights(epoch, num_epochs, N_MIN_13, batch_fvs.device)
    dist = samples_distortion.long()
    is_clean_anchor = (dist == 0) & mask
    levels = torch.arange(1, 6, device=batch_fvs.device)
    clean_neg = (~same_id) & valid & (dist[None, :] == 0)
    neg_sorted = _sorted_desc(sim, clean_neg)
    n_neg = clean_neg.sum(dim=1)
    is_d = (dist[None, None, :] == levels[:, None, None]) & mask[None, None, :]  # (5, 1, B)
    pos = same_id[None] & is_d                                                  # (5, B, B)
    p = torch.where(pos, sim[None], _inf_like(sim)[None]).amin(dim=2)            # (5, B)
    present = pos.any(dim=2)
    rank = torch.cumsum(present.long(), dim=0) - present.long()
    q = neg_sorted.gather(1, rank.T.clamp_max(n - 1)).T                          # (5, B)
    has = is_clean_anchor[None, :] & present & (rank < n_neg[None, :])
    term = torch.where(has, _softplus((q - p) / tau), torch.zeros_like(p))
    w = torch.where(has, table[levels][:, None].expand_as(p), torch.zeros_like(p))
    return (term * w).sum() / w.sum().clamp_min(_EPS)


def camera_hard_loss(batch_fvs, batch_labels, batch_camera_labels, camera_centers, center_ids,
                     center_cams, tau=0.1, sample_mask=None):
    """Camera-proxy triplets (``BatchCameraHardLoss``, ``losses.py:794-866``):
    each sample against its identity's other-camera centers, the j-th such
    center paired with the j-th most similar other-identity center of the
    sample's own camera, cycling when those run out (rank ``j mod n_neg``);
    the mean over the counted triplets. ``camera_centers`` (Nc, D) come
    with ``center_ids`` and ``center_cams`` (:func:`mine_camera_centers`)."""
    mask = _mask_or_ones(sample_mask, batch_fvs.shape[0], batch_fvs.device)
    sim = batch_fvs @ camera_centers.T
    same_id = batch_labels[:, None] == center_ids[None, :]
    same_cam = batch_camera_labels[:, None] == center_cams[None, :]
    pos_mask = same_id & ~same_cam
    neg_mask = (~same_id) & same_cam
    n_neg = neg_mask.sum(dim=1)
    neg_sorted = _sorted_desc(sim, neg_mask)
    ordinal = torch.cumsum(pos_mask.long(), dim=1) - 1
    rank = torch.remainder(ordinal, n_neg.clamp_min(1)[:, None])
    q = neg_sorted.gather(1, rank)
    per_pair = _softplus((q - sim) / tau)
    counted = pos_mask & (n_neg > 0)[:, None] & mask[:, None]
    total = torch.where(counted, per_pair, torch.zeros_like(per_pair)).sum()
    return total / counted.sum().clamp_min(1)


def median_softmax_triplet_loss(batch_fvs, batch_labels, tau=0.1, sample_mask=None):
    """Median-positive / median-negative softmax triplet
    (``BatchMedianSoftmaxTripletLoss``, ``losses.py:927-971``, the intended
    computation of a reference that does not run): each masked median is
    the lower middle element, index ``(n - 1) // 2`` of the row sorted with
    +inf padding."""
    mask = _mask_or_ones(sample_mask, batch_fvs.shape[0], batch_fvs.device)
    sim = batch_fvs @ batch_fvs.T
    pos_mask, neg_mask = _pairwise_masks(batch_labels, mask)

    def masked_median(keep):
        n = keep.sum(dim=1)
        srt = torch.sort(torch.where(keep, sim, _inf_like(sim)), dim=1, stable=True).values
        idx = torch.div(n - 1, 2, rounding_mode="floor").clamp_min(0)
        return srt.gather(1, idx[:, None])[:, 0], n > 0

    p, has_p = masked_median(pos_mask)
    q, has_q = masked_median(neg_mask)
    ok = has_p & has_q & mask
    per = torch.where(ok, _softplus((q - p) / tau), torch.zeros_like(p))
    return per.sum() / ok.sum().clamp_min(1)
