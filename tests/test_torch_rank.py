"""Ranking in the PyTorch port against the JAX package (CPU).

- kernel K2's plain version (``daliid_tpu_torch.ops.rank_counts``) against
  the Pallas kernel ``daliid_tpu.ops.rank_counts.positive_rank_counts`` in
  interpret mode: exact integer equality on every valid positive slot
  (invalid slots are garbage in the JAX contract and 0 in the port);
- the port's ``evaluate_rank`` against ``evaluate_rank_numpy`` (the float64
  oracle) and ``evaluate_rank_jax`` on one distmat. CMC equals the oracle's
  bit for bit; against the JAX package the hit counts behind it are equal
  and the curve is within one float32 ulp (XLA's division). mAP equals the
  oracle's to float64 summation order (|diff| <= 1e-12) and is identical
  once rounded to float32; against the JAX package, which accumulates AP in
  float32, mAP agrees within 1e-6.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daliid_tpu.metrics.ranking import evaluate_rank_jax, evaluate_rank_numpy
from daliid_tpu.ops.rank_counts import positive_rank_counts as jax_rank_counts
from daliid_tpu_torch.metrics.ranking import (
    evaluate_rank,
    max_positives_bound,
    positive_columns,
)
from daliid_tpu_torch.metrics.ranking import evaluate_rank_numpy as port_rank_numpy
from daliid_tpu_torch.ops.rank_counts import positive_rank_counts, rank_counts_plain

_I32MAX = np.iinfo(np.int32).max


def _problem(seed, nq, ng, ids, cams, ties):
    rng = np.random.default_rng(seed)
    if ties:  # quantized distances: many exact positive/negative ties
        distmat = rng.integers(0, 6, size=(nq, ng)).astype(np.float32) / 8.0
    else:
        distmat = rng.random((nq, ng)).astype(np.float32)
    return (distmat, rng.integers(0, ids, nq), rng.integers(0, ids, ng),
            rng.integers(0, cams, nq), rng.integers(0, cams, ng))


def _slots(distmat, q_pids, g_pids, q_cams, g_cams, ignore_camera, extra_p=0):
    """numpy prologue: the (p_dist, p_idx) thresholds both kernels take."""
    cols = positive_columns(q_pids, g_pids, max_positives_bound(g_pids) + extra_p)
    valid = cols >= 0
    safe = np.where(valid, cols, 0)
    pos = valid if ignore_camera else valid & (g_cams[safe] != q_cams[:, None])
    p_dist = np.where(pos, np.take_along_axis(distmat, safe, 1), np.inf).astype(np.float32)
    p_idx = np.where(pos, safe, _I32MAX).astype(np.int32)
    return p_dist, p_idx, pos


@pytest.mark.parametrize("ignore_camera", [False, True])
@pytest.mark.parametrize(
    "seed,nq,ng,ids,cams,ties,extra_p",
    [
        (0, 13, 57, 5, 3, True, 0),    # the tie fuzz of tests/test_metrics.py
        (1, 37, 211, 12, 4, False, 3),  # ragged Q, G and P
        (2, 29, 130, 4, 2, True, 5),
    ],
)
def test_rank_counts_plain_matches_pallas_interpret(seed, nq, ng, ids, cams, ties, extra_p,
                                                    ignore_camera):
    """Exact counts on every valid slot, tie-fuzzed and ragged shapes."""
    distmat, qp, gp, qc, gc = _problem(seed, nq, ng, ids, cams, ties)
    p_dist, p_idx, pos = _slots(distmat, qp, gp, qc, gc, ignore_camera, extra_p)
    i32 = lambda a: np.asarray(a, np.int32)
    want = np.asarray(jax_rank_counts(
        jnp.asarray(distmat), jnp.asarray(p_dist), jnp.asarray(p_idx),
        jnp.asarray(i32(qp)), jnp.asarray(i32(qc)), jnp.asarray(i32(gp)), jnp.asarray(i32(gc)),
        ignore_camera=ignore_camera, interpret=True,
    ))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = (t(distmat), t(p_dist), t(p_idx), t(i32(qp)), t(i32(qc)), t(i32(gp)), t(i32(gc)))
    got = positive_rank_counts(*args, ignore_camera=ignore_camera).numpy()
    assert pos.any()
    np.testing.assert_array_equal(got[pos], want[pos])
    assert np.all(got[~pos] == 0)
    np.testing.assert_array_equal(got, rank_counts_plain(*args, ignore_camera=ignore_camera).numpy())


@pytest.mark.parametrize("seed", range(6))
def test_evaluate_rank_matches_numpy_oracle(seed):
    """Default Market protocol: CMC exact, mAP to summation order."""
    ties = seed % 2 == 0
    distmat, qp, gp, qc, gc = _problem(seed, 13 + seed, 57 + 11 * seed, 5, 3, ties)
    cmc_n, map_n = evaluate_rank_numpy(distmat, qp, gp, qc, gc, max_rank=10)
    cmc, mAP = evaluate_rank(torch.from_numpy(distmat), qp, gp, qc, gc, max_rank=10,
                             query_chunk=4)
    np.testing.assert_array_equal(cmc, cmc_n)
    assert abs(mAP - map_n) <= 1e-12
    assert np.float32(mAP) == np.float32(map_n)
    # the port's copy of the oracle is the JAX package's, result for result
    cmc_p, map_p = port_rank_numpy(distmat, qp, gp, qc, gc, max_rank=10)
    np.testing.assert_array_equal(cmc_p, cmc_n)
    assert map_p == map_n


@pytest.mark.parametrize("count_all", [False, True])
@pytest.mark.parametrize("ignore_camera", [False, True])
def test_evaluate_rank_matches_jax(count_all, ignore_camera):
    """All four protocol combinations on one tie-fuzzed distmat: equal hit
    counts behind the CMC, the curve within one float32 ulp, mAP within 1e-6."""
    distmat, qp, gp, qc, gc = _problem(7, 41, 173, 9, 3, True)
    cmc_j, map_j = evaluate_rank_jax(
        jnp.asarray(distmat), jnp.asarray(qp.astype(np.int32)), jnp.asarray(gp.astype(np.int32)),
        jnp.asarray(qc.astype(np.int32)), jnp.asarray(gc.astype(np.int32)), max_rank=12,
        query_chunk=16, count_all=count_all, ignore_camera=ignore_camera,
    )
    cmc, mAP = evaluate_rank(torch.from_numpy(distmat), qp, gp, qc, gc, max_rank=12,
                             query_chunk=16, count_all=count_all, ignore_camera=ignore_camera)
    # the matched-query counts behind each CMC entry are equal; the curve
    # itself within one float32 ulp, because XLA on the CPU divides by a
    # constant denominator through its reciprocal, not correctly rounded
    same = gp[None, :] == qp[:, None]
    matched = (same if ignore_camera else same & (gc[None, :] != qc[:, None])).any(axis=1)
    denom = len(qp) if count_all else int(matched.sum())
    cmc_j = np.asarray(cmc_j).astype(np.float64)
    np.testing.assert_array_equal(np.rint(cmc * denom), np.rint(cmc_j * denom))
    np.testing.assert_allclose(cmc, cmc_j, rtol=2.0 ** -23, atol=0)
    assert abs(mAP - float(map_j)) <= 1e-6


def test_evaluate_rank_empty_query_set():
    """No queries: the CMC is still a (max_rank,) vector, as in the JAX
    package (commit f3c6194)."""
    distmat = torch.zeros((0, 5))
    cmc, mAP = evaluate_rank(distmat, np.zeros(0, int), np.arange(5), np.zeros(0, int),
                             np.zeros(5, int), max_rank=7)
    assert cmc.shape == (7,) and np.all(cmc == 0) and mAP == 0.0


def test_max_positives_guard_and_bound_match_jax():
    """The copied numpy helpers give the JAX package's tables."""
    from daliid_tpu.metrics.ranking import max_positives_bound as jax_bound
    from daliid_tpu.metrics.ranking import positive_columns as jax_cols

    gp = np.asarray([3, 7, 3, 3, 9, 0, 0, 0, 0, 0, 0, 0, 0, 0])
    qp = np.asarray([3, 9, 5, 7])
    assert max_positives_bound(gp) == jax_bound(gp) == 14
    np.testing.assert_array_equal(positive_columns(qp, gp, 14), jax_cols(qp, gp, 14))
    with pytest.raises(ValueError, match="max_positives"):
        positive_columns(qp, gp, 2)


def test_rank_counts_launch_or_raise_off_the_cpu():
    """Only a CPU tensor takes the plain version (no fallback)."""
    distmat, qp, gp, qc, gc = _problem(3, 5, 9, 3, 2, False)
    p_dist, p_idx, _ = _slots(distmat, qp, gp, qc, gc, False)
    i32 = lambda a: np.asarray(a, np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to("meta")
            for a in (distmat, p_dist, p_idx, i32(qp), i32(qc), i32(gp), i32(gc))]
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        positive_rank_counts(*args)
    assert positive_rank_counts.launches == 0


@pytest.mark.parametrize("n_q,n_g,n_p", [(0, 9, 4), (5, 0, 4), (5, 9, 0)])
def test_empty_rank_counts_count_no_launch(n_q, n_g, n_p):
    """With nothing to count the wrapper answers zeros without a kernel, off
    the CPU too, and its launch count stays where it was."""
    f32 = lambda *s: torch.zeros(s, dtype=torch.float32, device="meta")
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32, device="meta")
    out = positive_rank_counts(f32(n_q, n_g), f32(n_q, n_p), i32(n_q, n_p), i32(n_q),
                               i32(n_q), i32(n_g), i32(n_g))
    assert out.shape == (n_q, n_p) and out.dtype == torch.int32
    assert positive_rank_counts.launches == 0
