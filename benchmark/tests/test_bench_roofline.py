"""The yardstick's counts against counts worked by hand at small shapes."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from benchmark import roofline as rl
from benchmark.reference import resnet as ref_resnet, vit_jpm as ref_vit
from benchmark.roofline import models


def test_kernel_counts_by_hand():
    # K1: 30 operations a pixel; 3 uint8 in + 3 bf16 out a pixel, 64 table bytes an image
    assert rl.k1_augment(2, 4, 4) == (30 * 32, 2 * 16 * 3 * 3 + 2 * 64, "f32")
    # K2: one compare per gallery entry and counted positive
    assert rl.k2_rank_counts(3, 10, 8, 5) == (50, 4 * 30 + 8 * 24 + 8 * 13 + 4 * 24, "f32")
    # K3: a multiply-add per probe, row and column; rows, scales, probes, top-k out
    # (no cell drives K3 yet; the count is kept for the serving cell)
    assert rl.k3_sq8(2, 100, 8, 3) == (2 * 2 * 100 * 8, 800 + 400 + 16 + 48, "int8")
    # K4: QK^T and PV; q, k, v in and the output out in bf16
    assert rl.k4_attention(1, 4, 2, 8) == (4 * 1 * 2 * 16 * 8, 4 * 4 * 2 * 8 * 2, "bf16")


def test_least_time_takes_the_larger_bound():
    assert rl.least_seconds(0, 3.35e12, "bf16") == pytest.approx(1.0)
    assert rl.least_seconds(989e12, 1, "bf16") == pytest.approx(1.0)
    assert rl.kernel_roofline([(0, 3.35e9, "f32")] * 2, 4e-3) == pytest.approx(50.0)
    assert rl.kernel_roofline([], 1.0) is None


def test_resnet_flops_match_the_convolutions_of_a_forward():
    """Count the multiply-adds of every convolution the reference runs."""
    macs = []
    real = F.conv2d

    def counting(x, w, b=None, stride=1, padding=0, *a):
        y = real(x, w, b, stride, padding, *a)
        macs.append(y.numel() // y.shape[0] * w[0].numel())
        return y

    cfg = dict(ref_resnet.RESNET50, img_size=[64, 32])
    P = {n: torch.ones(s) * (0.01 if i == "fan_in" else 1.0) if i != "zeros" else torch.zeros(s)
         for n, s, i in ref_resnet.spec(cfg)}
    F.conv2d = counting
    try:
        ref_resnet.forward(cfg, P, torch.zeros(1, 3, 64, 32))
    finally:
        F.conv2d = real
    assert ref_resnet.flops(cfg) == 2.0 * sum(macs)
    assert ref_resnet.attention(cfg) == []


def test_jpm_flops_by_hand_at_a_small_grid():
    # 40x28 → a 3x2 grid (7 tokens); chunks of 1 + 6 // 4 = 2 tokens
    dim, mlp, n, c = 768, 3072, 7, 2

    def block(t):
        return t * (4 * dim * dim + 2 * dim * mlp) + 2 * t * t * dim

    macs = 6 * dim * 3 * 256 + 12 * block(n) + 4 * block(c) + 5 * dim * 10
    cfg = dict(ref_vit.TRANSREID_JPM, img_size=[40, 28], num_classes=10)
    assert models.transreid_jpm(40, 28, 10, dim, 12, mlp, 16, 12, 4) == 2.0 * macs
    assert ref_vit.flops(cfg, train=True) == 2.0 * macs
    assert ref_vit.flops(cfg) == 2.0 * (macs - 5 * dim * 10)
    # K4's launches a forward: the trunk and the global block, then the chunks
    assert ref_vit.attention(cfg) == [(12, n, 12, 64), (4, c, 12, 64)]
