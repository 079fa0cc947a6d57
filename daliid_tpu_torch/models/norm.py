"""Batch and instance normalization with the JAX package's numerics.

:class:`InstanceNorm` is flax's ``nn.InstanceNorm`` as the IBN block of
``daliid_tpu/models/resnet.py`` uses it (see its docstring).
:class:`TorchBatchNorm` ports ``daliid_tpu/models/norm.py::TorchBatchNorm``
(``:34-84``). Its mode follows ``self.training``:

- train: normalize with the biased batch variance and update the running
  variance with the unbiased one (``n / (n - 1)``), torch momentum 0.1
  (flax 0.9), as ``daliid_tpu/models/norm.py:63-79`` does;
- eval: the running statistics.

In both, the statistics and the affine are f32 (a bf16 input is upcast
inside torch's ``batch_norm``, whose running buffers stay f32 through an
update), and the result is cast to the compute dtype. Every row of the input
counts in the batch statistics, masked padding slots of a PK batch
included, as in the JAX package. The JAX package computes the batch
variance as ``E[x^2] - mean^2`` clipped at 0; torch uses Welford, so the two
agree to a tolerance. Parameters and buffers carry torch's names
(``weight``, ``bias``, ``running_mean``, ``running_var``) and there is no
``num_batches_tracked`` buffer, so a reference ``state_dict`` loads as it is
once that counter is dropped.

In a gang (:func:`daliid_tpu_torch.parallel.mesh.active`) the train mode
reduces over the global batch, as the JAX BN does under a sharded batch
(``daliid_tpu/models/norm.py:21-24``); the running variance takes the
unbiased estimate with the global count, and the backward sees the global
statistics (the per-channel sums of the backward are summed over the ranks
too). On a card, :class:`_GangBatchNorm` does it with torch's fused
statistics ops, one pass each way plus the normalize: ``batch_norm_stats``
gives each rank's Welford mean and inverse deviation, one all-reduce of a
(ranks, 2C + 1) table (each rank fills its row) gathers them,
``batch_norm_gather_stats_with_counts`` merges them and updates the running
statistics, and ``batch_norm_elemt`` normalizes; the backward is
``batch_norm_backward_reduce``, one all-reduce of the two per-channel sums
and ``batch_norm_backward_elemt``. Those ops have no CPU kernels, so on the
CPU :meth:`TorchBatchNorm._global_batch_norm_plain` computes the same
function eagerly: each rank's sum, sum of squares and count (from one f32
Welford pass, in float64) go through one autograd-aware ``all_reduce``
(``parallel/mesh.py::all_reduce_sum``), the batch variance is then
``E[x^2] - mean^2`` clipped at 0, the JAX package's formula, and the
normalize is one ``x * a + b`` pass. The two agree to rounding
(``chip_smoke.py`` holds them against each other on the card).
``nn.SyncBatchNorm`` is not used: its numerics and names differ, and it
needs a GPU once a group exists.
"""

from __future__ import annotations

import torch
from torch import nn

from daliid_tpu_torch.parallel.mesh import active, all_reduce_, all_reduce_sum, rank, world

# torch convention: new = (1 - momentum) * old + momentum * batch (flax 0.9)
MOMENTUM = 0.1


class TorchBatchNorm(nn.Module):
    """BatchNorm over the channel axis (dim 1) of an (N, C, ...) tensor."""

    def __init__(self, num_features: int, eps: float = 1e-5, dtype: torch.dtype | None = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and active():
            if x.is_cuda:
                y = _GangBatchNorm.apply(x, self.weight, self.bias, self.running_mean,
                                         self.running_var, self.eps)
                return y.to(self.dtype or x.dtype)
            return self._global_batch_norm_plain(x)
        # one fused pass: batch_norm reads a bf16 input, does its arithmetic in
        # f32 against the f32 parameters and statistics, writes x's dtype; in
        # train mode it updates the f32 running buffers in place
        y = torch.nn.functional.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            training=self.training, momentum=MOMENTUM, eps=self.eps,
        )
        return y.to(self.dtype or x.dtype)

    def _global_batch_norm_plain(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the gang's global batch, eagerly (see the module
        note)."""
        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        xf = x.float()
        n_local = x.numel() // c
        var_l, mean_l = torch.var_mean(xf, dims, correction=0)  # one f32 Welford pass
        mean_l = mean_l.double()
        f64 = torch.float64
        stats = all_reduce_sum(torch.cat([
            n_local * mean_l, n_local * (var_l.double() + mean_l * mean_l),
            mean_l.new_full((1,), float(n_local))]))
        n = stats[2 * c]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            unbiased = (var * (n / (n - 1.0).clamp_min(1.0))).float()
            self.running_mean.mul_(1.0 - MOMENTUM).add_(MOMENTUM * mean.float())
            self.running_var.mul_(1.0 - MOMENTUM).add_(MOMENTUM * unbiased)
        # y = x * a + (bias - mean * a), a = weight / sqrt(var + eps): one pass
        a = (torch.rsqrt(var + self.eps) * self.weight.to(f64))
        shift = self.bias.to(f64) - mean * a
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = torch.addcmul(shift.float().view(shape), xf, a.float().view(shape))
        return y.to(self.dtype or x.dtype)


class _GangBatchNorm(torch.autograd.Function):
    """Train-mode BN over the gang's global batch on a card, from torch's
    fused statistics ops (see the module note). The running buffers are
    updated in place; ``weight`` and ``bias`` take this rank's share of
    their gradients, which the trainer sums over the ranks with the rest."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps):
        c = x.shape[1]
        mean_l, invstd_l = torch.batch_norm_stats(x, eps)
        table = torch.zeros((world(), 2 * c + 1), dtype=mean_l.dtype, device=x.device)
        table[rank(), :c] = mean_l
        table[rank(), c:2 * c] = invstd_l
        table[rank(), 2 * c] = x.numel() // c
        all_reduce_(table)  # every rank's row: an all-gather that gloo takes on a card
        counts = table[:, 2 * c]
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, table[:, :c], table[:, c:2 * c], running_mean, running_var, MOMENTUM, eps, counts)
        ctx.save_for_backward(x, weight, mean, invstd, counts.to(torch.int32))
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)

    @staticmethod
    def backward(ctx, grad):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        memory_format = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
                         and not x.is_contiguous() else torch.contiguous_format)
        grad = grad.contiguous(memory_format=memory_format)
        sum_dy, sum_dy_xmu, grad_weight, grad_bias = torch.batch_norm_backward_reduce(
            grad, x, mean, invstd, weight, ctx.needs_input_grad[0], ctx.needs_input_grad[1],
            ctx.needs_input_grad[2])
        grad_x = None
        if ctx.needs_input_grad[0]:
            sums = all_reduce_(torch.cat([sum_dy, sum_dy_xmu]))
            sum_dy, sum_dy_xmu = sums.split(x.shape[1])
            grad_x = torch.batch_norm_backward_elemt(grad, x, mean, invstd, weight, sum_dy,
                                                     sum_dy_xmu, counts)
        return grad_x, grad_weight, grad_bias, None, None, None


class InstanceNorm(nn.Module):
    """flax ``nn.InstanceNorm(epsilon=1e-5)`` over an (N, C, H, W) tensor:
    each sample's and channel's mean and variance over H and W, computed in
    f32 whatever the input dtype, the variance flax's fast ``E[x^2] -
    E[x]^2`` clipped at 0; then ``(x - mean) * (rsqrt(var + eps) * weight)
    + bias`` in f32, cast to the compute dtype. ``weight`` and ``bias`` are
    the reference IBN block's ``IN.weight`` and ``IN.bias``; there are no
    running statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5, dtype: torch.dtype | None = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = ((xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight[:, None, None]
        y = (xf - mean) * mul + self.bias[:, None, None]
        return y.to(self.dtype or x.dtype)
