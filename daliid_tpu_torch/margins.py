"""Margin-based classifier heads: ArcFace, CosFace, AM-Softmax and Circle.

Port of ``daliid_tpu/margins.py`` (``:21-81``): logits over L2-normalized
embeddings and a class-weight matrix normalized per class, with the margin
applied to the target class. ``weights`` is (D, C), the layout of a flax
``Dense`` kernel; a ``torch.nn.Linear`` classifier passes ``weight.T``. The
reference's TransReID builders select a head with ``cfg.MODEL.ID_LOSS_TYPE``
(``Person-ReID/make_models.py:261-277``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _normalized_cosine(embeddings, weights):
    e = embeddings / (torch.linalg.vector_norm(embeddings, dim=1, keepdim=True) + 1e-12)
    w = weights / (torch.linalg.vector_norm(weights, dim=0, keepdim=True) + 1e-12)
    return torch.clamp(e @ w, -1.0 + 1e-7, 1.0 - 1e-7)


def _onehot(labels, cos):
    return F.one_hot(labels.long(), cos.shape[1]).to(cos.dtype)


def arcface_logits(embeddings, weights, labels, s: float = 30.0, m: float = 0.50):
    """Additive angular margin: cos(theta_y + m) on the target class."""
    cos = _normalized_cosine(embeddings, weights)
    target = torch.cos(torch.arccos(cos) + m)
    onehot = _onehot(labels, cos)
    return s * (onehot * target + (1.0 - onehot) * cos)


def cosface_logits(embeddings, weights, labels, s: float = 30.0, m: float = 0.35):
    """Additive cosine margin: cos(theta_y) - m on the target class."""
    cos = _normalized_cosine(embeddings, weights)
    return s * (cos - m * _onehot(labels, cos))


def amsoftmax_logits(embeddings, weights, labels, s: float = 30.0, m: float = 0.35):
    return cosface_logits(embeddings, weights, labels, s=s, m=m)


def circle_logits(embeddings, weights, labels, s: float = 48.0, m: float = 0.25):
    """Circle loss in classifier form: alpha_p (cos - (1 - m)) on the
    target, alpha_n (cos - m) elsewhere, alpha_p = max(1 + m - cos, 0),
    alpha_n = max(cos + m, 0)."""
    cos = _normalized_cosine(embeddings, weights)
    onehot = _onehot(labels, cos)
    logit_p = torch.clamp(1.0 + m - cos, min=0.0) * (cos - (1.0 - m))
    logit_n = torch.clamp(cos + m, min=0.0) * (cos - m)
    return s * (onehot * logit_p + (1.0 - onehot) * logit_n)


_HEADS = {
    "arcface": arcface_logits,
    "cosface": cosface_logits,
    "amsoftmax": amsoftmax_logits,
    "circle": circle_logits,
}


def margin_logits(kind: str, embeddings, weights, labels, **kw):
    if kind not in _HEADS:
        raise KeyError(f"unknown margin head {kind!r}; available: {sorted(_HEADS)}")
    return _HEADS[kind](embeddings, weights, labels, **kw)
