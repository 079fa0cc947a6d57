"""The yardstick of K4's backward: its operations and bytes counted by hand
at small shapes, the readers ``k4_grad_roofline.train_vit`` and
``wattn_grad_roofline.train_swin`` on the tiny configurations, and a trace
that holds the forward and the backward kernels' names, on which the
forward readers keep their launch counts."""

from __future__ import annotations

import pytest

from benchmark import roofline as rl
from benchmark.harness import core, models, tracing
from benchmark.roofline import attention_grad as ag, window_attention as wa
from benchmark.roofline.reading import k4_forward_launches
from benchmark.tests.tiny import tiny_config

# the device trace's names of the port's kernels (demangled, as torch.profiler
# gives them)
VIEWS = "(anonymous namespace)::View"
NAMES = {
    "k4": f"void (anonymous namespace)::attention_mma<64, 8>(__nv_bfloat16 const*, {VIEWS})",
    "wattn": f"void (anonymous namespace)::wattn_bias_mma<32>(__nv_bfloat16 const*, {VIEWS})",
    "dq": f"void (anonymous namespace)::k4_grad_dq<64>(__nv_bfloat16 const*, {VIEWS}, float*)",
    "dkv": f"void (anonymous namespace)::k4_grad_dkv<64>(__nv_bfloat16 const*, {VIEWS})",
    "wgrad": f"void (anonymous namespace)::wattn_grad_mma<32>(__nv_bfloat16 const*, {VIEWS})",
    "sum": "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
           "at::native::func_wrapper_t<float, at::native::sum_functor<float, float, float>"
           "::operator()(at::TensorIterator&)::{lambda(float, float)#1}>, unsigned int, float, 4>>",
}


def test_backward_counts_by_hand():
    # five products of 2 N^2 D a row and head; q, k, v, dO in and dq, dk, dv out in bf16
    assert ag.k4_grad(1, 4, 2, 8) == (5 * 2 * 1 * 2 * 16 * 8, 7 * 4 * 2 * 8 * 2, "bf16")
    # 2 images of 3 windows: 6 rows; the (G, H, N, N) bias read and dbias written in f32
    assert ag.wattn_grad(2, 3, 4, 2, 8, 3) == (
        5 * 2 * 6 * 2 * 16 * 8, 7 * 6 * 4 * 2 * 8 * 2 + 2 * 3 * 2 * 16 * 4, "bf16")
    # the backward's products are 2.5 times the forward's, its bytes 7/4 times
    fwd, bwd = rl.k4_attention(3, 5, 2, 32), ag.k4_grad(3, 5, 2, 32)
    assert (bwd[0] / fwd[0], bwd[1] / fwd[1]) == (2.5, 1.75)


def _trace(kernels: dict) -> tracing.Trace:
    """A trace with ``kernels`` {name: (launches, seconds a launch)}."""
    tr = tracing.Trace(window_s=10.0, busy_s=9.0)
    t = 0.0
    for name, (n, seconds) in kernels.items():
        for _ in range(n):
            tr.kernels.append((name, t, seconds * 1e6))
            t += seconds * 1e6
    return tr


def _run(config: dict, cell: str, tracer, steps=3, batch=8, mining_batches=2):
    run = core.Run(cell=cell, workload={}, config=config, seed=1, seconds=1.0, trace=True)
    run.counts.update(batch=batch, steps=steps, mining_batches=mining_batches)
    run.shapes.update(extract_batch=16, attention=models.reference(config).attention(config))
    run.tracer = tracer
    return run


def test_the_vit_reader_counts_two_kernels_a_call_of_the_steps():
    cfg = tiny_config("transreid_jpm")
    reader = core.metric_reader("k4_grad_roofline.train_vit")
    per_forward = models.reference(cfg).attention(cfg)
    calls = 3 * sum(c for c, *_ in per_forward)
    bound = sum(rl.least_seconds(*ag.k4_grad(8, n, h, d)) * c for c, n, h, d in per_forward) * 3
    a_call = 2 * bound / calls  # each call takes twice its least time, over its two kernels
    run = _run(cfg, "transreid_jpm.train-market",
               _trace({NAMES["dq"]: (calls, a_call / 4), NAMES["dkv"]: (calls, 3 * a_call / 4)}))
    assert reader.read(run) == pytest.approx(50.0)
    # one kernel a call, or a launch missing, reads nothing; so does the parent's trace
    one = _trace({NAMES["dq"]: (calls, a_call)})
    assert reader.read(_run(cfg, "transreid_jpm.train-market", one)) is None
    short = _trace({NAMES["dq"]: (calls, 1e-3), NAMES["dkv"]: (calls - 1, 1e-3)})
    assert reader.read(_run(cfg, "transreid_jpm.train-market", short)) is None
    parent = _trace({NAMES["k4"]: (calls + 2 * 4, 1e-3)})
    assert reader.read(_run(cfg, "transreid_jpm.train-market", parent)) is None
    assert reader.read(_run(cfg, "transreid_jpm.train-market", None)) is None


def test_the_swin_reader_counts_one_kernel_a_call_of_the_steps():
    cfg = core.load_json("configs", "swin_base")
    reader = core.metric_reader("wattn_grad_roofline.train_swin")
    per_forward = models.reference(cfg).window_attention(cfg)
    calls = 46 * 24
    bound = 46 * sum(c * rl.least_seconds(*ag.wattn_grad(384, w, n, h, d, g))
                     for c, w, n, h, d, g in per_forward)
    tracer = _trace({NAMES["wgrad"]: (calls, 4 * bound / calls), NAMES["sum"]: (calls, 1e-3)})
    run = _run(cfg, "swin_base.train-market", tracer, steps=46, batch=384, mining_batches=26)
    assert reader.read(run) == pytest.approx(25.0)
    parent = _trace({NAMES["wattn"]: (24 * (46 + 26), 1e-3)})
    assert reader.read(_run(cfg, "swin_base.train-market", parent, steps=46, batch=384)) is None
    # a model without biased attention reads nothing
    jpm = tiny_config("transreid_jpm")
    assert reader.read(_run(jpm, "transreid_jpm.train-market", tracer)) is None


@pytest.mark.parametrize("config,cell", [("transreid_jpm", "transreid_jpm.train-market"),
                                         ("swin_base", "swin_base.train-market")])
def test_backward_kernel_names_leave_the_forward_readers_as_they_were(config, cell):
    """A trace with both the forward and the backward kernels reads the same
    forward shares, from the same launch counts, as one with the forward
    kernels alone: no backward name holds a forward reader's stem."""
    cfg = tiny_config(config) if config == "transreid_jpm" else core.load_json("configs", config)
    steps, batch, mining = 3, 8, 2
    ref = models.reference(cfg)
    forward_k4 = len(k4_forward_launches([batch] * steps + [16] * mining, ref.attention(cfg)))
    forward_wattn = len(wa.launches([batch] * steps + [16] * mining,
                                    getattr(ref, "window_attention", lambda c: [])(cfg)))
    forward = {NAMES["k4"]: (forward_k4, 2e-4), NAMES["wattn"]: (forward_wattn, 3e-4)}
    both = dict(forward, **{NAMES["dq"]: (5, 1e-4), NAMES["dkv"]: (5, 1e-4),
                            NAMES["wgrad"]: (7, 1e-4), NAMES["sum"]: (7, 1e-5)})
    for reader in ("k4_roofline.train_vit", "wattn_roofline.train_swin"):
        read = core.metric_reader(reader).read
        alone = read(_run(cfg, cell, _trace(forward), steps, batch, mining))
        assert read(_run(cfg, cell, _trace(both), steps, batch, mining)) == alone
    assert (core.metric_reader("k4_roofline.train_vit").read(
        _run(cfg, cell, _trace(forward), steps, batch, mining)) is None) == (forward_k4 == 0)
    tr = _trace(both)
    for stems in (("attention_mma", "attention_f32"), ("wattn_bias_mma",),
                  ("fused_augment_kernel",), ("rank_counts_kernel",), ("topk_pass",)):
        n = tr.device_seconds(stems)[0]
        assert n == {("attention_mma", "attention_f32"): forward_k4,
                     ("wattn_bias_mma",): forward_wattn}.get(stems, 0)
    assert tr.device_seconds(ag.K4_GRAD)[0] == 10 and tr.device_seconds(ag.WATTN_GRAD)[0] == 7
