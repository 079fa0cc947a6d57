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
  float32, mAP agrees within 1e-6;
- the CUDA kernel's design (rank by counting, a binary search into bins, a
  prefix sum), emulated in plain torch, exactly equal to the interpret-mode
  Pallas kernel on every valid slot;
- the positive-slot bound: ``evaluate_rank`` sizes P by the queried pids
  (``queried_positives_bound``), not by every gallery pid, with the CMC and
  mAP unchanged.

Inputs are made with numpy from a seed and handed to both packages.
"""

import re
from pathlib import Path


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
    queried_positives_bound,
)
from daliid_tpu_torch.metrics.ranking import evaluate_rank_numpy as port_rank_numpy
from daliid_tpu_torch.ops.rank_counts import positive_rank_counts, rank_counts_plain

_I32MAX = np.iinfo(np.int32).max
REPO = Path(__file__).resolve().parents[1]


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


# ---- the CUDA kernel's design, emulated in plain torch ----
def _kernel_constant(name: str) -> int:
    src = (REPO / "daliid_tpu_torch" / "csrc" / "rank_counts.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _bucket(x, tmin, scale, n_buckets):
    """The kernel's bucket + 1 in f32: trunc(RN(RN(x - tmin) * scale))
    clamped to [-1, n_buckets - 1] (NaN converts to 0, as cvt.rzi does)."""
    v = torch.trunc((x - tmin) * scale)
    v = torch.nan_to_num(v, nan=0.0, posinf=float(n_buckets), neginf=-1.0)
    return v.clamp(-1, n_buckets - 1).long() + 1


def _sort_keys(t, pi):
    """Rank by counting over (t, pi, position) → the sorted order."""
    at = torch.arange(len(t))
    before = (t[None, :] < t[:, None]) | ((t[None, :] == t[:, None])
                                          & ((pi[None, :] < pi[:, None])
                                             | ((pi[None, :] == pi[:, None])
                                                & (at[None, :] < at[:, None]))))
    order = torch.empty_like(at)
    order[before.sum(dim=1)] = at
    return order


def _bins(ts, pis, d, j, n_buckets):
    """Bins of columns (d, j) against sorted keys (ts, pis) by the kernel's
    lookup table: the keys in lower buckets, plus a compare with each key
    of the column's own bucket."""
    n = len(ts)
    tmin, tmax = ts[0], ts[-1]
    rng = tmax - tmin
    scale = (torch.tensor(float(n_buckets)) / rng if bool(rng > 0) and bool(torch.isfinite(rng))
             else torch.tensor(0.0))
    key_bucket = _bucket(ts, tmin, scale, n_buckets)
    slots = torch.arange(n_buckets + 1)
    lut_lo = (key_bucket[None, :] < slots[:, None]).sum(dim=1)
    lut_cnt = (key_bucket[None, :] == slots[:, None]).sum(dim=1)
    u = _bucket(d, tmin, scale, n_buckets)
    lo, cnt = lut_lo[u], lut_cnt[u]
    at = torch.arange(n)
    own = (at[None, :] >= lo[:, None]) & (at[None, :] < (lo + cnt)[:, None])
    at_or_after = ~((d[:, None] < ts[None, :]) | ((d[:, None] == ts[None, :])
                                                  & (j[:, None] < pis[None, :])))
    return lo + (own & at_or_after).sum(dim=1)


def _k2_emulation(dist, p_dist, p_idx, q_pids, q_cams, g_pids, g_cams, ignore_camera,
                  keys_per_pass, n_buckets):
    """``csrc/rank_counts.cu`` step for step: each query's valid slots in
    slot order, ``keys_per_pass`` at a time, sorted by counting; every column
    at or before the largest key binned through the bucket table, junk
    included; the junk columns' bins taken back out; a prefix sum of the
    bins written to the slots. Invalid slots are 0."""
    n_q, n_g = dist.shape
    out = torch.zeros(p_dist.shape, dtype=torch.int32)
    cols = torch.arange(n_g)
    for q in range(n_q):
        junk = (g_pids == q_pids[q]) & (g_cams == q_cams[q])
        valid = torch.nonzero(p_dist[q] < float("inf")).flatten()
        for s in range(0, len(valid), keys_per_pass):
            slots = valid[s:s + keys_per_pass]
            order = _sort_keys(p_dist[q, slots], p_idx[q, slots])
            ts, pis, slots = p_dist[q, slots][order], p_idx[q, slots][order], slots[order]
            n = len(ts)
            near = dist[q] <= ts[-1]
            hist = torch.bincount(_bins(ts, pis, dist[q][near], cols[near], n_buckets),
                                  minlength=n + 1)
            if not ignore_camera:
                back = near & junk
                hist = hist - torch.bincount(_bins(ts, pis, dist[q][back], cols[back],
                                                   n_buckets), minlength=n + 1)
            out[q, slots] = torch.cumsum(hist[:n], 0).to(torch.int32)
    return out


def _k2_case(case):
    """A (Q, G, P) problem with distinct random positive columns per query,
    some slots invalid, and the named edge case written in."""
    seed, nq, ng, n_p, ties, keep = {
        "ties": (10, 13, 57, 9, True, 0.8),
        "duplicate_keys": (11, 9, 64, 8, True, 0.9),
        "own_column_junk": (12, 7, 90, 6, False, 1.0),
        "all_invalid": (13, 6, 40, 5, True, 0.7),
        "odd_g": (14, 11, 211, 12, False, 0.8),
        "more_than_one_pass": (15, 3, 301, 160, True, 1.0),
    }[case]
    rng = np.random.default_rng(seed)
    distmat, qp, gp, qc, gc = _problem(seed, nq, ng, 5, 3, ties)
    cols = np.argsort(rng.random((nq, ng)), axis=1)[:, :n_p]
    valid = rng.random((nq, n_p)) < keep
    p_dist = np.where(valid, np.take_along_axis(distmat, cols, 1), np.inf).astype(np.float32)
    p_idx = np.where(valid, cols, _I32MAX).astype(np.int32)
    if case == "duplicate_keys":  # slot 1 repeats slot 0's (t, pi), slot 3 slot 2's
        p_dist[:, [1, 3]], p_idx[:, [1, 3]] = p_dist[:, [0, 2]], p_idx[:, [0, 2]]
    if case == "own_column_junk":  # query 0's first positive sits on a junk column
        j = int(p_idx[0, 0])
        gp[j], gc[j] = qp[0], qc[0]
    if case == "all_invalid":
        p_dist[1], p_idx[1] = np.inf, _I32MAX
    return distmat, p_dist, p_idx, qp, qc, gp, gc


@pytest.mark.parametrize("ignore_camera", [False, True])
@pytest.mark.parametrize("case", ["ties", "duplicate_keys", "own_column_junk", "all_invalid",
                                  "odd_g", "more_than_one_pass"])
def test_kernel_design_emulation_matches_pallas_interpret(case, ignore_camera):
    """The emulated kernel equals the interpret-mode Pallas kernel exactly on
    every valid slot, and the plain version everywhere (0 at invalid slots)."""
    distmat, p_dist, p_idx, qp, qc, gp, gc = _k2_case(case)
    i32 = lambda a: np.asarray(a, np.int32)
    want = np.asarray(jax_rank_counts(
        jnp.asarray(distmat), jnp.asarray(p_dist), jnp.asarray(p_idx),
        jnp.asarray(i32(qp)), jnp.asarray(i32(qc)), jnp.asarray(i32(gp)), jnp.asarray(i32(gc)),
        ignore_camera=ignore_camera, interpret=True,
    ))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = (t(distmat), t(p_dist), t(p_idx), t(i32(qp)), t(i32(qc)), t(i32(gp)), t(i32(gc)))
    keys_per_pass = _kernel_constant("kKeys")
    if case == "more_than_one_pass":
        assert int((p_dist < np.inf).sum(axis=1).max()) > keys_per_pass
    got = _k2_emulation(*args, ignore_camera=ignore_camera, keys_per_pass=keys_per_pass,
                        n_buckets=_kernel_constant("kBuckets"))
    pos = p_dist < np.inf
    np.testing.assert_array_equal(got.numpy()[pos], want[pos])
    np.testing.assert_array_equal(got.numpy(), rank_counts_plain(
        *args, ignore_camera=ignore_camera).numpy())


@pytest.mark.parametrize("keys", ["random", "one", "equal", "minus_inf", "huge_range", "ties"])
def test_bucket_table_bins_like_a_direct_count(keys):
    """The bucket table's bin of every column equals the direct count of
    keys at or before it: random keys, one key, equal keys (a zero range),
    a -inf key and an overflowing range (scale 0: one bucket), tied keys."""
    rng = np.random.default_rng(30)
    t = {"random": rng.random(17), "one": [0.3], "equal": [0.5] * 5,
         "minus_inf": [-np.inf, 0.1, 0.7], "huge_range": [-3e38, 0.0, 3e38],
         "ties": rng.integers(0, 4, 40) / 8.0}[keys]
    t = torch.tensor(np.asarray(t, np.float32))
    pi = torch.from_numpy(rng.integers(0, 50, len(t)).astype(np.int32))
    order = _sort_keys(t, pi)
    ts, pis = t[order], pi[order]
    d = torch.from_numpy(np.concatenate([rng.random(500) * 1.2 - 0.1, rng.integers(0, 5, 100) / 8.0,
                                         t.numpy(), [-0.0, 0.0]]).astype(np.float32))
    j = torch.from_numpy(rng.integers(0, 50, len(d)).astype(np.int32))
    want = (~((d[:, None] < ts[None, :]) | ((d[:, None] == ts[None, :])
                                            & (j[:, None] < pis[None, :])))).sum(dim=1)
    got = _bins(ts, pis, d, j, _kernel_constant("kBuckets"))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---- the positive-slot bound ----
def _distractor_table(seed):
    """32 queries of 8 pids, each pid in the gallery 3-6 times over all three
    cameras (so every query has a kept positive), and 120 gallery rows of a
    distractor pid 0 that no query asks for, as Market-1501's pid 0."""
    rng = np.random.default_rng(seed)
    mult = rng.integers(3, 7, 8)
    g_pids = np.concatenate([np.repeat(np.arange(1, 9), mult), np.zeros(120, np.int64)])
    g_cams = np.concatenate([np.arange(m) % 3 for m in mult] + [rng.integers(0, 3, 120)])
    order = rng.permutation(g_pids.size)
    g_pids, g_cams = g_pids[order], g_cams[order]
    q_pids = rng.integers(1, 9, 32)
    q_cams = rng.integers(0, 3, 32)
    distmat = (rng.integers(0, 12, (32, g_pids.size)) / 8.0).astype(np.float32)  # ties
    return distmat, q_pids, g_pids, q_cams, g_cams


def test_queried_positives_bound():
    gp = np.asarray([3, 7, 3, 3, 9, 0, 0, 0, 0, 0, 0, 0, 0, 0])
    assert queried_positives_bound([3, 9], gp) == 8
    assert queried_positives_bound([0, 3], gp) == 16 == max_positives_bound(gp) + 2
    assert queried_positives_bound([5], gp) == 8  # no queried pid in the gallery
    assert queried_positives_bound([5], []) == 8
    assert queried_positives_bound([1], np.repeat([1], 17)) == 24


@pytest.mark.parametrize("count_all", [False, True])
@pytest.mark.parametrize("ignore_camera", [False, True])
def test_evaluate_rank_bounds_p_by_the_queried_pids(count_all, ignore_camera, monkeypatch):
    """P is the queried bound (8), not the distractor's 120; the CMC equals
    the numpy oracle's and the JAX package's bit for bit (32 valid queries:
    every curve value is k / 32, exact in float32), and equals the port's
    own ranking at the unbounded P; mAP within 1e-12 of both, and within
    1e-6 of the JAX package's float32 sum."""
    import daliid_tpu_torch.metrics.ranking as port_ranking

    distmat, qp, gp, qc, gc = _distractor_table(20)
    seen = []

    def recording(dist, p_dist, *rest, **kw):
        seen.append(p_dist.shape[1])
        return positive_rank_counts(dist, p_dist, *rest, **kw)

    monkeypatch.setattr(port_ranking, "positive_rank_counts", recording)
    kw = dict(max_rank=20, count_all=count_all, ignore_camera=ignore_camera)
    cmc, mAP = evaluate_rank(torch.from_numpy(distmat), qp, gp, qc, gc, **kw)
    assert seen == [queried_positives_bound(qp, gp)] == [8]
    assert max_positives_bound(gp) == 120
    cmc_u, map_u = evaluate_rank(torch.from_numpy(distmat), qp, gp, qc, gc,
                                 max_positives=max_positives_bound(gp), **kw)
    assert seen[-1] == 120
    np.testing.assert_array_equal(cmc, cmc_u)
    assert abs(mAP - map_u) <= 1e-12
    i32 = lambda a: jnp.asarray(np.asarray(a, np.int32))
    cmc_j, map_j = evaluate_rank_jax(jnp.asarray(distmat), i32(qp), i32(gp), i32(qc), i32(gc),
                                     **kw)
    np.testing.assert_array_equal(cmc, np.asarray(cmc_j).astype(np.float64))
    assert abs(mAP - float(map_j)) <= 1e-6
    if not ignore_camera:  # the oracle's protocol; every query is valid, so count_all agrees
        cmc_n, map_n = evaluate_rank_numpy(distmat, qp, gp, qc, gc, max_rank=20)
        np.testing.assert_array_equal(cmc, cmc_n)
        assert abs(mAP - map_n) <= 1e-12
