"""Weibull meta-recognition score fusion on the device.

Port of ``daliid_tpu/eval/meta_recognition.py``, the reference's ``libmr`` /
``Meta_Recognition`` pair (``Person-ReID/evaluate.py:394-627``):

- :func:`weibull_mle`: row-wise 2-parameter Weibull maximum-likelihood fits
  by Newton-Raphson on the shape, 100 iterations with each row frozen at
  its iterate once |Δk| < eps (the JAX ``lax.fori_loop`` with its mask: a
  frozen row keeps the shape and scale of the iteration it converged in);
- :func:`fit_tail`: ``FitHigh`` (sign +1) / ``FitLow`` (sign -1) over each
  row's top ``tail_size`` scores, translated past the smallest of them;
- :func:`wscore`: the Weibull CDF of scores under per-column fits;
- :func:`metarec`: per gallery column, a Weibull over the scores left
  after each row's top k are removed → the CDF confidence of every score;
- :func:`mrfuse`: the confidence-weighted blend of three similarity
  matrices.

Everything is float32 on the tensors' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class WeibullFit(NamedTuple):
    shape: torch.Tensor        # (N,) k
    scale: torch.Tensor        # (N,) lambda
    small_score: torch.Tensor  # (N,) tail translation anchor
    sign: int                  # +1 FitHigh, -1 FitLow
    translate: float


def weibull_mle(data: torch.Tensor, iters: int = 100, eps: float = 1e-6):
    """Row-wise Weibull MLE of ``data`` (N, M), x > 0 → (shape, scale)."""
    data = data.float()
    ln_x = torch.log(data)
    mean_ln_x = ln_x.mean(dim=1)
    n = data.shape[0]
    k = torch.ones(n, dtype=data.dtype, device=data.device)
    done = torch.zeros(n, dtype=torch.bool, device=data.device)
    k_rec, lam_rec = k.clone(), torch.ones_like(k)
    for _ in range(iters):
        x_k = data ** k[:, None]
        x_k_ln = x_k * ln_x
        fg = x_k.sum(dim=1)
        ff = x_k_ln.sum(dim=1)
        ff_prime = (x_k_ln * ln_x).sum(dim=1)
        ff_by_fg = ff / fg
        f = ff_by_fg - mean_ln_x - 1.0 / k
        f_prime = (ff_prime / fg - ff_by_fg ** 2) + 1.0 / (k * k)
        k_new = torch.where(done, k, k - f / f_prime)
        newly_done = ~done & ((k_new - k).abs() < eps)
        lam = (data ** k_new[:, None]).mean(dim=1) ** (1.0 / k_new)
        k_rec = torch.where(newly_done, k_new, k_rec)
        lam_rec = torch.where(newly_done, lam, lam_rec)
        k, done = k_new, done | newly_done
    # rows that never converged: the last iterate
    lam_final = (data ** k[:, None]).mean(dim=1) ** (1.0 / k)
    return torch.where(done, k_rec, k), torch.where(done, lam_rec, lam_final)


def fit_tail(data: torch.Tensor, tail_size: int, sign: int = 1,
             translate: float = 1.0) -> WeibullFit:
    """Weibull over the top ``tail_size`` of ``data * sign`` per row."""
    tail = torch.topk(data * sign, tail_size, dim=1).values
    small = tail[:, tail_size - 1]
    processed = tail + translate - small[:, None]
    shape, scale = weibull_mle(processed.clamp_min(1e-12))
    return WeibullFit(shape=shape, scale=scale, small_score=small, sign=sign,
                      translate=translate)


def wscore(fit: WeibullFit, scores: torch.Tensor, reversed_: bool = False) -> torch.Tensor:
    """Weibull CDF confidence of ``scores`` (R, N) under N per-column fits."""
    x = (scores * fit.sign + fit.translate - fit.small_score[None, :]).clamp_min(0.0)
    cdf = 1.0 - torch.exp(-((x / fit.scale[None, :]) ** fit.shape[None, :]))
    return 1.0 - cdf if reversed_ else cdf


def metarec(score_matrix: torch.Tensor, topk: int = 20, kill_scale: float = 1.0) -> torch.Tensor:
    """Meta-recognition weights of a (Q, G) similarity matrix (the
    reference's ``use_columns=False``): each row's top-k scores removed, a
    Weibull per gallery column over what is left, and the CDF confidence of
    every original score under its column's fit."""
    q = score_matrix.shape[0]
    scores = torch.nan_to_num(score_matrix.float(), nan=0.0)
    top_vals, top_idx = torch.topk(scores, topk, dim=1)
    kill = torch.zeros_like(scores).scatter_(1, top_idx, top_vals)
    tail_scores = torch.nan_to_num((scores - kill_scale * kill).T, nan=0.0)  # (G, Q)
    fit = fit_tail(tail_scores, max(q - topk - 1, 2), sign=1)
    return torch.nan_to_num(wscore(fit, score_matrix.float()), nan=0.0)


def mrfuse(s1: torch.Tensor, s2: torch.Tensor, s3: torch.Tensor, topk: int = 20) -> torch.Tensor:
    """Confidence-weighted fusion of three similarity matrices."""
    w1, w2, w3 = metarec(s1, topk), metarec(s2, topk), metarec(s3, topk)
    return (w1 * s1 + w2 * s2 + w3 * s3) / (w1 + w2 + w3 + 1e-12)
