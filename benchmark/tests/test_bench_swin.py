"""Swin-B's plain reference against the program at tiny sizes on the CPU (at
its configured widths and at other widths), its FLOPs and biased-attention
launches counted by hand, and the reader ``wattn_roofline.train_swin``'s
count of launches."""

from __future__ import annotations

import pytest
import torch

from benchmark import roofline as rl
from benchmark.harness import core, models
from benchmark.reference import swin as ref_swin
from benchmark.roofline import window_attention as wa


def _config(**widths) -> dict:
    cfg = dict(core.load_json("configs", "swin_base"), img_size=[64, 32],
               compute_dtype="float32", **widths)
    cfg["feature_dim"] = cfg["embed_dim"] * 2 ** (len(cfg["depths"]) - 1)
    return cfg


@pytest.mark.parametrize("widths", [{}, dict(embed_dim=16, depths=[2, 2], num_heads=[2, 4],
                                             window_size=3, shift_size=1)],
                         ids=["published", "other_widths"])
@pytest.mark.parametrize("train", [False, True])
def test_swin_matches_the_programs_in_float32(train, widths):
    cfg = _config(**widths)
    w = models.make_weights(cfg, 6, "cpu")
    for n in w:  # bias tables far from the init's 0.02, so that they count
        if n.endswith("relative_position_bias_table"):
            w[n].normal_(0.0, 1.0, generator=torch.Generator().manual_seed(1))
    x = torch.randn(4, 3, 64, 32, generator=torch.Generator().manual_seed(2))
    m = models.build_program(cfg, w, "cpu").module
    m.train(train)
    want = m(x, generator=torch.Generator().manual_seed(8))
    got = ref_swin.forward(cfg, {k: v.clone() for k, v in w.items()}, x, train,
                           generator=torch.Generator().manual_seed(8))
    assert ((got - want).norm(dim=1) / want.norm(dim=1)).max() < 1e-5


def test_swin_flops_and_launches_by_hand_at_a_small_grid():
    # 40x24, patch 4 → 10x6 (padded by window 3 to 12x6, 8 windows), then 5x3 (6x3, 2)
    cfg = dict(embed_dim=16, depths=[2, 2], num_heads=[2, 4], window_size=3, shift_size=1,
               mlp_ratio=4.0, patch_size=4, img_size=[40, 24])
    assert ref_swin.grids(cfg) == [((10, 6), (12, 6)), ((5, 3), (6, 3))]
    n = 9

    def block(dim, real, padded):
        return padded * 4 * dim * dim + 2 * padded * n * dim + 2 * real * dim * 4 * dim

    macs = (10 * 6 * 16 * 48 + 2 * block(16, 60, 72) + 2 * block(32, 15, 18)
            + 5 * 3 * 4 * 16 * 32)
    assert ref_swin.flops(cfg) == 2.0 * macs == ref_swin.flops(cfg, train=True)
    assert ref_swin.attention(cfg) == []
    assert ref_swin.window_attention(cfg) == [(1, 8, 9, 2, 8, 1), (1, 8, 9, 2, 8, 8),
                                              (1, 2, 9, 4, 8, 1), (1, 2, 9, 4, 8, 2)]
    # one launch: QK^T and PV; q, k, v in and the output out in bf16, the bias once in f32
    assert wa.wattn_bias(3, 8, 9, 2, 8, 8) == (4 * 24 * 2 * 81 * 8,
                                               4 * 24 * 9 * 2 * 8 * 2 + 8 * 2 * 81 * 4, "bf16")


def test_swin_b_at_384x128_as_its_configuration_states():
    cfg = core.load_json("configs", "swin_base")
    assert ref_swin.flops(cfg) == pytest.approx(39.41e9, rel=1e-3)
    per = ref_swin.window_attention(cfg)
    assert sum(c[0] for c in per) == 24
    # every stage bound by its bytes; 4.79 ms a forward at batch 384
    bound = sum(rl.least_seconds(*c) for c in wa.launches([384], per))
    assert bound == pytest.approx(4.79e-3, rel=1e-3)
    assert all(c[1] / rl.HBM_BYTES_PER_S > c[0] / rl.PEAK_OPS["bf16"]
               for c in wa.launches([384], per))


class _Tracer:
    def __init__(self, launches: int, seconds: float):
        self.launches, self.seconds = launches, seconds

    def device_seconds(self, names):
        assert names == ("wattn_bias_mma",)
        return self.launches, self.seconds


def _run(tracer, config="swin_base"):
    run = core.Run(cell="swin_base.train-market", workload={}, config=core.load_json(
        "configs", config), seed=1, seconds=1.0, trace=True)
    run.counts.update(batch=384, steps=46, mining_batches=26)
    run.shapes.update(extract_batch=512)
    run.tracer = tracer
    return run


def test_the_reader_counts_the_steps_and_minings_launches():
    reader = core.metric_reader("wattn_roofline.train_swin")
    cfg = core.load_json("configs", "swin_base")
    launches = 24 * (46 + 26)
    bound = sum(rl.least_seconds(*c) for c in wa.launches(
        [384] * 46 + [512] * 26, ref_swin.window_attention(cfg)))
    assert reader.read(_run(_Tracer(launches, 2 * bound))) == pytest.approx(50.0)
    # a trace that holds another count of launches reads nothing
    assert reader.read(_run(_Tracer(launches - 1, 2 * bound))) is None
    assert reader.read(_run(_Tracer(0, 0.0))) is None
    assert reader.read(_run(None)) is None
    # a model without biased attention reads nothing
    assert reader.read(_run(_Tracer(launches, 1.0), config="transreid_jpm")) is None
