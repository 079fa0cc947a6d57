"""The plain reference against the program at tiny sizes on the CPU: the
augmentation, the losses, mining, the two models (at their configured
widths and at other widths), and the ranking, each on the same inputs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import models
from benchmark.reference import augment as ref_aug, losses as ref_losses
from benchmark.reference import mining as ref_mining, ranking as ref_ranking
from benchmark.reference import resnet as ref_resnet, vit_jpm as ref_vit


def test_augmentation_matches_the_programs_plain_k1():
    from daliid_tpu_torch.ops.fused_augment import draw_scalars, fused_augment_plain

    u8 = torch.randint(0, 256, (6, 32, 16, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(1))
    want = fused_augment_plain(u8, draw_scalars(6, 32, 16, 10, 0.4, 0.3, 0.4, (0.05, 0.3),
                                                (0.3, 3.3), torch.Generator().manual_seed(3)),
                               10, torch.float32)
    got = ref_aug.augment(u8, ref_aug.draw(6, 32, 16, torch.Generator().manual_seed(3)))
    assert (got - want).abs().max() < 1e-5


def test_losses_match_the_programs():
    import daliid_tpu_torch.losses as L

    g = torch.Generator().manual_seed(0)
    f = torch.nn.functional.normalize(torch.randn(12, 16, generator=g), dim=1)
    labels = torch.arange(12) // 3
    levels = torch.randint(0, 6, (12,), generator=g)
    mask = torch.ones(12, dtype=torch.bool)
    mask[-1] = False
    centers = torch.nn.functional.normalize(torch.randn(4, 16, generator=g), dim=1)
    proxies = torch.nn.functional.normalize(torch.randn(12, 16, generator=g), dim=1)
    plabels = torch.tensor([0, 0, 0, 1, 1, 2, 2, 2, 3, -1, -1, 3])
    logits = torch.randn(12, 4, generator=g)
    pairs = [
        (ref_losses.center_loss(f, labels, levels, mask, centers, 3, 250, 0.05),
         L.weighted_center_loss(f, labels, levels, centers, 3, 250, tau=0.05,
                                sample_mask=mask)[0]),
        (ref_losses.proxy_loss(f, labels, levels, mask, proxies, plabels, 3, 250, 0.05),
         L.weighted_proxy_loss(f, labels, levels, proxies, plabels, 3, 250, tau=0.05,
                               sample_mask=mask, p_max=3)),
        (ref_losses.cross_entropy(logits, labels, levels, mask, 3, 250),
         L.weighted_cross_entropy_loss(torch.softmax(logits, 1), labels, levels, 3, 250,
                                       sample_mask=mask)[0]),
        (ref_losses.softmax_triplet(f, labels, levels, mask, 3, 250, 0.05),
         L.weighted_softmax_triplet_loss(f, labels, levels, 3, 250, tau=0.05,
                                         sample_mask=mask)),
    ]
    for got, want in pairs:
        assert abs(float(got) - float(want)) < 1e-5 * max(1.0, abs(float(want)))


def test_mining_matches_the_programs():
    from daliid_tpu_torch.train.proxies import mine_proxies_and_centers

    rng = np.random.default_rng(4)
    feats = rng.normal(size=(40, 8)).astype(np.float32)
    cls = rng.integers(0, 6, 40).astype(np.int32)
    want = mine_proxies_and_centers(feats, cls, 7, 5, np.random.default_rng(9))
    got = ref_mining.mine(feats, cls, 7, 5, np.random.default_rng(9))
    assert np.array_equal(got[2], want.proxy_labels)
    assert np.abs(got[0] - want.centers).max() == 0 and np.abs(got[1] - want.proxies).max() == 0


def _config(name: str, **widths) -> dict:
    cfg = dict(models.core.load_json("configs", name), img_size=[64, 32],
               compute_dtype="float32", **widths)
    if "embed_dim" in widths:
        cfg["feature_dim"] = (1 + cfg["divide_length"]) * cfg["embed_dim"]
    return cfg


def test_resnet_matches_the_programs_in_float32():
    cfg = _config("resnet50")
    w = models.make_weights(cfg, 5, "cpu")
    x = torch.randn(4, 3, 64, 32, generator=torch.Generator().manual_seed(2))
    m = models.build_program(cfg, w, "cpu").module.eval()
    want = m(x.contiguous(memory_format=torch.channels_last))
    got = ref_resnet.forward(cfg, dict(w), x, False)
    assert ((got - want).norm(dim=1) / want.norm(dim=1)).max() < 1e-5


@pytest.mark.parametrize("widths", [{}, dict(embed_dim=96, depth=3, num_heads=3, mlp_ratio=2.0)],
                         ids=["published", "other_widths"])
@pytest.mark.parametrize("train", [False, True])
def test_transreid_jpm_matches_the_programs_in_float32(train, widths):
    cfg = _config("transreid_jpm", num_classes=5, **widths)
    w = models.make_weights(cfg, 6, "cpu")
    x = torch.randn(4, 3, 64, 32, generator=torch.Generator().manual_seed(2))
    m = models.build_program(cfg, w, "cpu").module
    m.train(train)
    want = m(x, generator=torch.Generator().manual_seed(8))
    got = ref_vit.forward(cfg, {k: v.clone() for k, v in w.items()}, x, train,
                          generator=torch.Generator().manual_seed(8))
    if train:
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            assert (a - b).abs().max() < 1e-4 * max(1.0, float(b.abs().max()))
    else:
        assert ((got - want).norm(dim=1) / want.norm(dim=1)).max() < 1e-5


def test_a_configuration_at_widths_the_program_does_not_build_fails_at_once():
    cfg = _config("resnet50", stage_widths=[32, 64, 128, 256])
    with pytest.raises(RuntimeError, match="size mismatch"):
        models.build_program(cfg, models.make_weights(cfg, 1, "cpu"), "cpu")


def test_the_fp8_control_rounds_the_backward_too():
    from benchmark.reference.precision import Precision

    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0), requires_grad=True)
    w = torch.randn(4, 16, generator=torch.Generator().manual_seed(1))
    g = torch.randn(8, 4, generator=torch.Generator().manual_seed(2)) * 1e-3
    grads = {}
    for mode in ("f32", "fp8"):
        p = Precision(mode)
        x.grad = None
        p.grad(torch.nn.functional.linear(p(x), p(w))).backward(g)
        grads[mode] = x.grad.clone()
    exact = g @ Precision("fp8")(w)
    assert (grads["f32"] - g @ w).abs().max() < 1e-6
    # the gradient reached the product as e5m2 (2 mantissa bits): off by up to 1/8
    rel = ((grads["fp8"] - exact).abs().max() / exact.abs().max()).item()
    assert 1e-3 < rel < 0.25


def test_ranking_matches_the_programs_oracle():
    from daliid_tpu_torch.metrics.ranking import evaluate_rank_numpy

    rng = np.random.default_rng(0)
    q, g = rng.normal(size=(30, 8)), rng.normal(size=(120, 8))
    qp, gp = rng.integers(0, 10, 30), rng.integers(0, 10, 120)
    qc, gc = rng.integers(1, 4, 30), rng.integers(1, 4, 120)
    cmc, m_ap, _ = ref_ranking.evaluate(q, g, qp, gp, qc, gc, dtype=torch.float64, chunk=7)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    gn = g / np.linalg.norm(g, axis=1, keepdims=True)
    want = evaluate_rank_numpy(1 - qn @ gn.T, qp, gp, qc, gc)
    assert np.abs(cmc - want[0]).max() == 0 and abs(m_ap - want[1]) < 1e-12
