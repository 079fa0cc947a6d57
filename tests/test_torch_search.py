"""Gallery search in the PyTorch port against the JAX package (CPU).

- kernel K3's plain version (``daliid_tpu_torch.ops.search_topk``) against
  the Pallas kernel in interpret mode (``chunk=128``, Q not a multiple of
  the 128-probe tile, num_real < G): SQ8 values and indices bit-exact; f32
  values within rtol 1e-5 and equal top-k index sets;
- the port's ``GalleryIndex`` against the JAX ``GalleryIndex`` (f32 and
  int8) through add, remove, save and load: the same retrieval, and each
  package loads the other's ``.npz``; k = 100, past K3's cap, through the
  library route: indices equal, SQ8 values bit-exact; The JAX index on the CPU scores with
  ``acc * q_scale * g_scale`` where the port (like the TPU kernel) takes
  ``(acc * g_scale) * q_scale``, so SQ8 values agree within rtol 1e-6 and
  indices exactly;
- the CUDA kernel's f32 arithmetic (exact three-piece bf16 split, six piece
  products, f32 sums a 16-element stage at a time) emulated in plain torch
  against the plain version with ``chip_smoke.py``'s f32 check, and 3xTF32
  beside it, which misses that check on scores near zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daliid_tpu.eval.matcher import GalleryIndex as JaxIndex
from daliid_tpu.ops.search_topk import f32_search_topk as jax_f32
from daliid_tpu.ops.search_topk import sq8_search_topk as jax_sq8
from daliid_tpu_torch.eval.matcher import GalleryIndex
from daliid_tpu_torch.ops.search_topk import MAX_K, f32_search_topk, sq8_search_topk

G, Q, D, NUM_REAL = 512, 130, 32, 420


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return {
        "q8": rng.integers(-127, 128, size=(Q, D)).astype(np.int8),
        "g8": rng.integers(-127, 128, size=(G, D)).astype(np.int8),
        "gs": rng.uniform(0.5, 1.5, G).astype(np.float32),
        "qf": rng.normal(size=(Q, D)).astype(np.float32),
        "gf": rng.normal(size=(G, D)).astype(np.float32),
    }


@pytest.mark.parametrize("k", [1, 6, 64])
def test_sq8_plain_matches_pallas_interpret_bit_exact(data, k):
    v_j, i_j = jax_sq8(data["q8"], data["g8"], jnp.asarray(data["gs"]), jnp.int32(NUM_REAL), k,
                       chunk=128, interpret=True)
    v, i = sq8_search_topk(torch.from_numpy(data["q8"]), torch.from_numpy(data["g8"]),
                           torch.from_numpy(data["gs"]), NUM_REAL, k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    assert i.dtype == torch.int32 and int(i.max()) < NUM_REAL


@pytest.mark.parametrize("k", [1, 6, 64])
def test_f32_plain_matches_pallas_interpret(data, k):
    v_j, i_j = jax_f32(data["qf"], data["gf"], jnp.int32(NUM_REAL), k, chunk=128,
                       interpret=True)
    v, i = f32_search_topk(torch.from_numpy(data["qf"]), torch.from_numpy(data["gf"]),
                           NUM_REAL, k)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-5, atol=1e-6)
    for r in range(Q):
        assert set(i[r].tolist()) == set(np.asarray(i_j)[r].tolist())


def test_ties_order_by_index_and_missing_slots():
    """Bit-identical gallery rows tie exactly: the lower index comes first.
    With k > num_real the extra slots are (-inf, -1)."""
    g8 = torch.tensor([[1, 2], [3, 4], [1, 2], [3, 4], [0, 1]], dtype=torch.int8)
    gs = torch.ones(5)
    v, i = sq8_search_topk(torch.tensor([[1, 1]], dtype=torch.int8), g8, gs, 4, 6)
    assert i.tolist() == [[1, 3, 0, 2, -1, -1]]
    assert v[0, :4].tolist() == [7.0, 7.0, 3.0, 3.0] and torch.isinf(v[0, 4:]).all()


def test_k_above_64_raises(data):
    """K3's wrappers refuse k > 64; the index routes such a k around them."""
    q8, g8, gs = (torch.from_numpy(data[n]) for n in ("q8", "g8", "gs"))
    with pytest.raises(ValueError, match="k <= 64"):
        sq8_search_topk(q8, g8, gs, NUM_REAL, MAX_K + 1)
    with pytest.raises(ValueError, match="k <= 64"):
        f32_search_topk(torch.from_numpy(data["qf"]), torch.from_numpy(data["gf"]), NUM_REAL, 65)
    index = GalleryIndex(data["gf"], np.arange(G), device="cpu")
    vals, idx, pids = index.search(data["qf"][:2], k=65)
    assert vals.shape == idx.shape == pids.shape == (2, 65)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_k_above_64_matches_the_jax_index(quantize):
    """k = 100 over 200 rows (a 256-row capacity, so padding rows exist),
    with exact duplicate rows: the library route returns the JAX index's
    indices and pids, ties lowest index first, and its values bit-exact in
    SQ8 (the XLA route's scale order over an exact integer product), within
    rtol 1e-6 in f32 (two products' summation orders); no K3 launch is
    counted."""
    rng = np.random.default_rng(9)
    gallery = rng.normal(size=(200, 40)).astype(np.float32)
    gallery[150:] = gallery[:50]
    pids = rng.integers(0, 30, 200)
    probes = np.concatenate([rng.normal(size=(5, 40)).astype(np.float32), gallery[:2]])
    port = GalleryIndex(gallery, pids, quantize=quantize, device="cpu")
    jidx = JaxIndex(gallery, pids, quantize=quantize)
    v, i, p = port.search(probes, k=100)
    vj, ij, pj = jidx.search(probes, k=100)
    assert v.shape == i.shape == (7, 100) and i.dtype == np.int32
    np.testing.assert_array_equal(i, ij)
    np.testing.assert_array_equal(p, pj)
    if quantize:
        np.testing.assert_array_equal(v, vj)
    else:
        np.testing.assert_allclose(v, vj, rtol=1e-6, atol=1e-7)
    assert (np.diff(v, axis=1) <= 0).all()
    assert sq8_search_topk.launches == 0 and f32_search_topk.launches == 0


def _same_retrieval(port, jax_idx, probes, k, rtol):
    v, i, p = port.search(probes, k=k)
    vj, ij, pj = jax_idx.search(probes, k=k)
    np.testing.assert_allclose(v, vj, rtol=rtol, atol=1e-7)
    np.testing.assert_array_equal(i, ij)
    np.testing.assert_array_equal(p, pj)
    assert port.num_gallery == jax_idx.num_gallery
    np.testing.assert_array_equal(port._host_gallery, jax_idx._host_gallery)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_gallery_index_matches_jax(tmp_path, quantize):
    """add (in place and past the capacity), remove, save and load — and
    cross-loading of each package's file."""
    rng = np.random.default_rng(5)
    dim = 24
    gallery = rng.normal(size=(37, dim)).astype(np.float32)
    pids = rng.integers(0, 9, 37)
    probes = rng.normal(size=(5, dim)).astype(np.float32)
    rtol = 1e-6 if quantize else 1e-5
    port = GalleryIndex(gallery, pids, quantize=quantize, device="cpu")
    jidx = JaxIndex(gallery, pids, quantize=quantize)
    _same_retrieval(port, jidx, probes, 7, rtol)

    for n_new in (3, 40):  # in place, then a capacity rebuild
        extra = rng.normal(size=(n_new, dim)).astype(np.float32)
        extra_pids = rng.integers(100, 120, n_new)
        port.add(extra, extra_pids)
        jidx.add(extra, extra_pids)
        _same_retrieval(port, jidx, probes, 7, rtol)

    gone = np.nonzero(np.isin(port.gallery_pids, [1, 2, 101]))[0]
    port.remove(gone)
    jidx.remove(gone)
    _same_retrieval(port, jidx, probes, 7, rtol)

    port.save(str(tmp_path / "port.npz"))
    jidx.save(str(tmp_path / "jax.npz"))
    from_jax = GalleryIndex.load(str(tmp_path / "jax.npz"), device="cpu")
    from_port = JaxIndex.load(str(tmp_path / "port.npz"))
    assert from_jax.quantize == from_port.quantize == quantize
    _same_retrieval(from_jax, from_port, probes, 7, rtol)
    # a load re-normalizes the saved rows, so reloads compare with reloads
    _same_retrieval(GalleryIndex.load(str(tmp_path / "port.npz"), device="cpu"),
                    JaxIndex.load(str(tmp_path / "jax.npz")), probes, 7, rtol)


def test_wrappers_launch_or_raise_off_the_cpu(data):
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel, which refuses what is not CUDA (no fallback)."""
    q8, g8, gs = (torch.from_numpy(data[n]).to("meta") for n in ("q8", "g8", "gs"))
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        sq8_search_topk(q8, g8, gs, NUM_REAL, 5)
    qf, gf = (torch.from_numpy(data[n]).to("meta") for n in ("qf", "gf"))
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        f32_search_topk(qf, gf, NUM_REAL, 5)
    assert sq8_search_topk.launches == 0 and f32_search_topk.launches == 0


@pytest.mark.parametrize("n_q,num_real", [(0, NUM_REAL), (3, 0)])
def test_empty_search_counts_no_launch(data, n_q, num_real):
    """No probes or no real rows: off the CPU the wrappers answer without a
    kernel, so their launch counts stay where they were."""
    q8, g8, gs = (torch.from_numpy(data[n]).to("meta") for n in ("q8", "g8", "gs"))
    qf, gf = (torch.from_numpy(data[n]).to("meta") for n in ("qf", "gf"))
    for run in (lambda: sq8_search_topk(q8[:n_q], g8, gs, num_real, 5),
                lambda: f32_search_topk(qf[:n_q], gf, num_real, 5)):
        vals, idx = run()
        assert vals.shape == idx.shape == (n_q, 5)
        assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    assert sq8_search_topk.launches == 0 and f32_search_topk.launches == 0


# ---- the f32 tensor-core kernel's arithmetic, emulated in plain torch ----

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16_pieces(x: torch.Tensor):
    """x = x0 + x1 + x2 in bf16 pieces (each rounding takes the next 8 bits)."""
    x0 = x.bfloat16().float()
    x1 = (x - x0).bfloat16().float()
    return x0, x1, (x - x0 - x1).bfloat16().float()


def _pieces_dot(q, g, scheme: str) -> torch.Tensor:
    """q . g^T from piece products, each exact, summed in float64: '3xtf32'
    (hi = tf32(x), lo = tf32(x - hi); lo.hi + hi.lo + hi.hi) or 'bf16x3'
    (the six products of bf16 pieces whose orders sum to at most 2)."""
    dot = lambda a, b: a.double() @ b.double().T
    if scheme == "3xtf32":
        qh, gh = _tf32(q), _tf32(g)
        ql, gl = _tf32(q - qh), _tf32(g - gh)
        return dot(ql, gh) + dot(qh, gl) + dot(qh, gh)
    a, b = _bf16_pieces(q), _bf16_pieces(g)
    return sum(dot(a[i], b[j]) for i in range(3) for j in range(3) if i + j <= 2)


def _kernel_f32_scores(q, g) -> torch.Tensor:
    """K3's f32 arithmetic: the bf16-piece products of each 16-element stage
    summed (rounded to f32 once), the stages added in f32 in order."""
    a, b = _bf16_pieces(q), _bf16_pieces(g)
    stages = lambda x: x.double().unflatten(1, (-1, 16))  # (rows, stages, 16)
    parts = sum(torch.einsum("qsd,gsd->sqg", stages(a[i]), stages(b[j]))
                for i in range(3) for j in range(3) if i + j <= 2).float()
    acc = torch.zeros(parts.shape[1:], dtype=torch.float32)
    for part in parts:
        acc = acc + part
    return acc


def _topk(scores: torch.Tensor, k: int):
    v, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def test_three_bf16_pieces_are_exact():
    x = torch.from_numpy(np.random.default_rng(5).normal(size=4096).astype(np.float32))
    x = x * torch.from_numpy(np.exp2(np.random.default_rng(6).integers(-20, 20, 4096))).float()
    assert torch.equal(sum(_bf16_pieces(x)), x)


@pytest.mark.parametrize("k", [10, 64])
def test_f32_tensor_core_arithmetic_matches_plain(k):
    """At the timed shape's width (D = 2048) over a few thousand rows, the
    kernel's stage-wise bf16-piece arithmetic, and 3xTF32 too, hold
    chip_smoke's f32 check against the plain version: values within 1e-5
    relative, equal index sets."""
    rng = np.random.default_rng(12)
    q = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(8, 2048))).float(), dim=1)
    g = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(3000, 2048))).float(), dim=1)
    vp, ip = f32_search_topk(q, g, 3000, k)
    for scores in (_kernel_f32_scores(q, g), _pieces_dot(q, g, "3xtf32").float()):
        v, i = _topk(scores, k)
        assert float(((v - vp).abs() / vp.abs()).max()) <= 1e-5
        assert torch.equal(torch.sort(i, dim=1).values, torch.sort(ip.long(), dim=1).values)


def test_3xtf32_misses_scores_near_zero_that_bf16_pieces_keep():
    """Why K3's f32 mode takes three bf16 pieces and not 3xTF32: on short
    rows (D = 16, k = 64 over 40 rows, as in chip_smoke's phase 3) some
    score lies near zero, where 3xTF32's 2^-21 error
    relative to |q||g| is more than 1e-5 of the score; the bf16 pieces are
    exact and drop only products below 2^-23. Both held against the float64
    dot of the same f32 inputs."""
    rng = np.random.default_rng(4)
    q = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(3, 16))).float(), dim=1)
    g = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(40, 16))).float(), dim=1)
    exact = q.double() @ g.double().T
    rel = {s: float(((_pieces_dot(q, g, s) - exact).abs() / exact.abs()).max())
           for s in ("3xtf32", "bf16x3")}
    assert rel["3xtf32"] > 1e-5 > 10 * rel["bf16x3"]
