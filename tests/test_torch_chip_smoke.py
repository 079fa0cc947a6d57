"""``chip_smoke.py``'s layout, on the CPU (no card, nothing built).

Every ``KERNELS`` entry names its check phase, its timing and the main-path
phases that launch it, and ``main`` runs exactly those for named kernels.
Each kernel's bound is read from ``benchmark.roofline``'s count wherever the
benchmark counts that kernel, so the kernel tables and the benchmark's
rooflines share one yardstick; the two kernels the benchmark does not time
keep counts of their own.
"""

from __future__ import annotations

import pytest

import benchmark.roofline as roofline
import chip_smoke as smoke
from benchmark.roofline import attention_grad, window_attention

# each kernel a cell of the benchmark counts, with the benchmark's count
BENCHMARK_COUNTS = {"rank_counts": roofline.k2_rank_counts, "search_topk_sq8": roofline.k3_sq8,
                    "fused_augment": roofline.k1_augment, "flash_attention": roofline.k4_attention,
                    "wattn_bias_mma": window_attention.wattn_bias,
                    "k4_grad": attention_grad.k4_grad, "wattn_grad_mma": attention_grad.wattn_grad}
# the kernels no cell times, with the op type of their local count
LOCAL_COUNTS = {"search_topk_f32": "tf32x3", "conv_int8": "int8"}
# sizes of a call of each kernel, as its timing passes them to ``_timing``
SIZES = {"rank_counts": (3368, 15913, 48, 40000), "search_topk_sq8": (64, 1 << 20, 2048, 10),
         "search_topk_f32": (64, 1 << 20, 2048, 10), "fused_augment": (384, 256, 128),
         "flash_attention": (384, 211, 12, 64), "wattn_bias_mma": (384, 70, 49, 4, 32, 70),
         "k4_grad": (384, 53, 12, 64), "wattn_grad_mma": (384, 8, 49, 16, 32, 1),
         "conv_int8": (512 * 512 * 16 * 8 * 2, 512 * 512 * 9, 512 * 16 * 8, 512, 4608)}


def test_every_kernel_has_a_count_and_sizes():
    assert set(smoke.KERNELS) == set(BENCHMARK_COUNTS) | set(LOCAL_COUNTS) == set(SIZES)


@pytest.mark.parametrize("name", list(smoke.KERNELS))
def test_entry_names_a_check_a_timing_and_path_phases_that_exist(name):
    entry = smoke.KERNELS[name]
    for fn, table in ((entry["checked_by"], smoke.CHECKS), (entry["timed_by"], smoke.TIMINGS)):
        assert callable(getattr(smoke, fn, None)) and fn in table
    assert entry["path"]
    for phase in entry["path"]:
        assert callable(getattr(smoke, phase, None)) and phase in smoke.PATH
    assert name in smoke.PATH_KERNELS
    assert name in smoke.Counts().counters


@pytest.mark.parametrize("name", sorted(BENCHMARK_COUNTS))
def test_bound_is_the_benchmarks_own_count(name):
    assert smoke.KERNELS[name]["count"] is BENCHMARK_COUNTS[name]
    ops, nbytes, op_type = BENCHMARK_COUNTS[name](*SIZES[name])
    entry = smoke._timing(name, SIZES[name], "shape", 1.0, 2.0, None, 0.0)
    assert entry["bound_ms"] == roofline.least_seconds(ops, nbytes, op_type) * 1e3
    assert (entry["ops"], entry["bytes"]) == (ops, nbytes)
    by_bytes = nbytes / roofline.HBM_BYTES_PER_S >= ops / roofline.PEAK_OPS[op_type]
    assert entry["bound_by"] == ("bytes" if by_bytes else "operations")


@pytest.mark.parametrize("name,op_type", sorted(LOCAL_COUNTS.items()))
def test_local_count_of_a_kernel_no_cell_times(name, op_type):
    count = smoke.KERNELS[name]["count"]
    assert count.__module__ == smoke.__name__
    ops, nbytes, got_type = count(*SIZES[name])
    assert got_type == op_type and ops > 0 and nbytes > 0
    peak = smoke.TF32X3_OPS_PER_S if op_type == "tf32x3" else roofline.PEAK_OPS[op_type]
    entry = smoke._timing(name, SIZES[name], "shape", 1.0, 2.0, None, 0.0)
    assert entry["bound_ms"] == max(nbytes / roofline.HBM_BYTES_PER_S, ops / peak) * 1e3


def test_named_backward_kernels_run_their_check_both_train_phases_and_timings():
    assert smoke.plan(["k4_grad", "wattn_grad_mma"]) == (
        ["phase_k4_grad"], ["phase_transformer_train", "phase_swin_train"],
        ["_time_k4_grad", "_time_wattn_grad"])


def test_no_names_run_every_check_timing_and_main_path_phase_once():
    checks, path, timings = smoke.plan([])
    assert checks == list(smoke.CHECKS) and timings == list(smoke.TIMINGS)
    assert path == list(smoke.PATH)


def test_named_phases_keep_the_full_runs_order():
    _, path, _ = smoke.plan(["conv_int8", "rank_counts", "flash_attention"])
    assert path == ["phase_evaluate", "phase_transformer_evaluate", "phase_transformer_train",
                    "phase_evaluate_int8"]


@pytest.mark.parametrize("argv", [["k5"], ["k4_grad", "k5"], ["--grad"], ["--swin"]])
def test_unknown_names_and_modes_are_refused(argv, capsys):
    assert smoke.main(argv) == 2
    assert "usage" in capsys.readouterr().out
