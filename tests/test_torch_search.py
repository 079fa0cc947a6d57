"""Gallery search in the PyTorch port against the JAX package (CPU).

- kernel K3's plain version (``daliid_tpu_torch.ops.search_topk``) against
  the Pallas kernel in interpret mode (``chunk=128``, Q not a multiple of
  the 128-probe tile, num_real < G): SQ8 values and indices bit-exact; f32
  values within rtol 1e-5 and equal top-k index sets;
- the port's ``GalleryIndex`` against the JAX ``GalleryIndex`` (f32 and
  int8) through add, remove, save and load: the same retrieval, and each
  package loads the other's ``.npz``. The JAX index on the CPU scores with
  ``acc * q_scale * g_scale`` where the port (like the TPU kernel) takes
  ``(acc * g_scale) * q_scale``, so SQ8 values agree within rtol 1e-6 and
  indices exactly.
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
    q8, g8, gs = (torch.from_numpy(data[n]) for n in ("q8", "g8", "gs"))
    with pytest.raises(ValueError, match="k <= 64"):
        sq8_search_topk(q8, g8, gs, NUM_REAL, MAX_K + 1)
    with pytest.raises(ValueError, match="k <= 64"):
        f32_search_topk(torch.from_numpy(data["qf"]), torch.from_numpy(data["gf"]), NUM_REAL, 65)
    index = GalleryIndex(data["gf"], np.arange(G), device="cpu")
    with pytest.raises(ValueError, match="k <= 64"):
        index.search(data["qf"][:2], k=65)


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
