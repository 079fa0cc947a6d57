"""k-reciprocal re-ranking of the port against the JAX package (CPU).

- ``re_ranking`` on the same numpy distance matrices (the k-NN sets are
  discrete, so both packages are handed the same float32 inputs): Q=20,
  G=60 cosine distances with duplicated rows, so that ties are exact and
  must break by index as ``jnp.argsort`` breaks them, at k1=20, k2=6; also
  k1 and k2 above N, other k1/k2/lambda, and lambda 1, which gives back the
  query-gallery matrix exactly. Within 1e-5 (float32: the port sums the
  Jaccard minimum over each query's support, the JAX package over every
  column; measured about 2e-7);
- ``rerank_shortlists`` batched against the JAX one, within 1e-5;
- ``GalleryIndex.search(rerank=True)``, f32 and SQ8, against the JAX index:
  equal indices and pids, scores within 1e-5; with one probe and
  ``rerank_depth >= num_gallery`` the scores are ``1 - re_ranking`` on the
  probe's and the gallery's cosine distances, as the JAX docstring states;
- ``evaluate --rerank`` and ``search --rerank`` of both packages on one
  Synthetic set (8 identities, 64x32) with one weight set (flax
  ``ResNet50ReID(stage_sizes=(1, 1, 1, 1))`` saved by ``save_variables``,
  ``resnet50`` rebound in both registries, both decoding with PIL): the
  ranked distmats within 2e-5 (the forwards' embeddings differ in float32
  summation order), CMC equal and mAP within 1e-6; the search's top-1 pids
  equal;
- ``--rerank`` with ``--multiple_output`` or a multi-head model is
  refused, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daliid_tpu.data.native_loader as jax_native_loader
import daliid_tpu.eval.validate as jax_validate
import daliid_tpu.models.factory as jax_factory
import daliid_tpu_torch.data.native_loader as port_native_loader
import daliid_tpu_torch.eval.validate as port_validate
import daliid_tpu_torch.models.factory as port_factory
from daliid_tpu.cli import evaluate as jax_evaluate
from daliid_tpu.cli import search as jax_search
from daliid_tpu.eval.matcher import GalleryIndex as JaxIndex
from daliid_tpu.eval.rerank import re_ranking as jax_re_ranking
from daliid_tpu.eval.rerank import rerank_shortlists as jax_rerank_shortlists
from daliid_tpu.models.resnet import ResNet50ReID as FlaxResNet
from daliid_tpu.train.checkpoint import save_variables
from daliid_tpu_torch.cli import evaluate as port_evaluate
from daliid_tpu_torch.cli import search as port_search
from daliid_tpu_torch.data import make_synthetic_dataset
from daliid_tpu_torch.eval.matcher import GalleryIndex
from daliid_tpu_torch.eval.rerank import re_ranking, rerank_shortlists
from daliid_tpu_torch.models.resnet import ResNet50ReID

TOL = 1e-5
STAGES = (1, 1, 1, 1)
IMG = (64, 32)


def _cosine(a, b):
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    return (1.0 - a @ b.T).astype(np.float32)


def _distmats(q=20, g=60, dim=16, seed=0):
    """Cosine distances with exact duplicates: every third gallery row
    repeats the one before it, and every fourth query is a gallery row."""
    rng = np.random.default_rng(seed)
    qf = rng.normal(size=(q, dim)).astype(np.float32)
    gf = rng.normal(size=(g, dim)).astype(np.float32)
    gf[1::3] = gf[0::3][: len(gf[1::3])]
    qf[::4] = gf[: len(qf[::4])]
    return _cosine(qf, gf), _cosine(qf, qf), _cosine(gf, gf)


@pytest.mark.parametrize("k1,k2,lam", [(20, 6, 0.3), (5, 3, 0.5), (3, 10, 0.3), (100, 90, 0.3),
                                       (20, 6, 1.0)])
def test_re_ranking_matches_jax(k1, k2, lam):
    qg, qq, gg = _distmats()
    for d in (qg, gg):  # exact ties within rows
        assert (np.diff(np.sort(d, axis=1), axis=1) == 0).sum() >= 20
    want = np.asarray(jax_re_ranking(qg, qq, gg, k1=k1, k2=k2, lambda_value=lam))
    got = re_ranking(qg, qq, gg, k1=k1, k2=k2, lambda_value=lam)
    assert got.shape == (20, 60) and got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    if lam == 1.0:
        np.testing.assert_array_equal(got.numpy(), qg)


def test_re_ranking_takes_tensors_on_their_device():
    qg, qq, gg = (torch.from_numpy(d) for d in _distmats(q=6, g=15, seed=1))
    got = re_ranking(qg, qq, gg)
    want = np.asarray(jax_re_ranking(qg.numpy(), qq.numpy(), gg.numpy()))
    assert torch.is_tensor(got) and got.device == qg.device
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_rerank_shortlists_matches_jax():
    rng = np.random.default_rng(2)
    f = rng.normal(size=(9, 33, 12)).astype(np.float32)
    f[:, 5] = f[:, 4]  # duplicate candidates: exact ties
    f /= np.linalg.norm(f, axis=2, keepdims=True)
    fulls = (1.0 - np.einsum("qid,qjd->qij", f, f)).astype(np.float32)
    want = np.asarray(jax_rerank_shortlists(jnp.asarray(fulls), k1=20, k2=6, lambda_value=0.3))
    got = rerank_shortlists(torch.from_numpy(fulls), 20, 6, 0.3)
    assert got.shape == (9, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # each instance alone gives the bits it gives in the batch
    for i in (0, 4):
        alone = rerank_shortlists(torch.from_numpy(fulls[i:i + 1]), 20, 6, 0.3)
        assert torch.equal(alone[0], got[i])


def _gallery(seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(20, 32)).astype(np.float32)
    g = np.repeat(centers, 4, axis=0) + 0.6 * rng.normal(size=(80, 32)).astype(np.float32)
    g[3::8] = g[2::8]  # exact duplicate rows
    probes = centers[:6] + 0.6 * rng.normal(size=(6, 32)).astype(np.float32)
    return g, np.repeat(np.arange(20), 4), probes


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("k,depth", [(5, 32), (10, 64), (3, 200)])
def test_gallery_search_rerank_matches_the_jax_index(quantize, k, depth):
    g, pids, probes = _gallery()
    port = GalleryIndex(g, pids, quantize=quantize, device="cpu")
    jidx = JaxIndex(g, pids, quantize=quantize)
    v, i, p = port.search(probes, k=k, rerank=True, rerank_depth=depth)
    vj, ij, pj = jidx.search(probes, k=k, rerank=True, rerank_depth=depth)
    assert v.shape == (6, k)
    np.testing.assert_array_equal(i, ij)
    np.testing.assert_array_equal(p, pj)
    np.testing.assert_allclose(v, vj, rtol=0, atol=TOL)
    assert (np.diff(v, axis=1) <= 1e-6).all()


def test_one_probe_at_full_depth_equals_re_ranking():
    g, pids, probes = _gallery(seed=4)
    index = GalleryIndex(g, pids, device="cpu")
    vals, idx, _ = index.search(probes[:1], k=80, rerank=True, rerank_depth=80, rerank_k1=5,
                                rerank_k2=3, rerank_lambda=0.3)
    qn = probes[:1] / (np.linalg.norm(probes[:1], axis=1, keepdims=True) + 1e-12)
    gn = index._host_gallery
    want = re_ranking(1.0 - qn @ gn.T, 1.0 - qn @ qn.T, 1.0 - gn @ gn.T, k1=5, k2=3,
                      lambda_value=0.3).numpy()[0]
    np.testing.assert_allclose(1.0 - vals[0], want[idx[0]], rtol=0, atol=TOL)
    assert sorted(idx[0].tolist()) == list(range(80))


def test_validator_refuses_reranking_head_tuples():
    v = port_validate.Validator(img_size=IMG, device="cpu", rerank=True)
    heads = tuple(np.ones((2, 4), np.float32) for _ in range(2))
    with pytest.raises(ValueError, match="rerank"):
        v.rank_features(heads, heads, None, None)


# ---------------------------------------------------------------- the CLIs
def _recording(ranked, log):
    def rank(self, distmat, queries, gallery):
        cmc, mAP = ranked(self, distmat, queries, gallery)
        d = distmat.cpu().numpy() if torch.is_tensor(distmat) else np.asarray(distmat)
        log.append((d, np.asarray(cmc), float(mAP)))
        return cmc, mAP

    return rank


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``evaluate --rerank`` and ``search --rerank`` on one
    set and one weight set → {(package, cli): (result, rankings)}."""
    root = tmp_path_factory.mktemp("torch_rerank")
    make_synthetic_dataset(str(root / "data" / "Synthetic"), num_ids=8, imgs_per_id_train=1,
                           imgs_per_id_test=3, with_turbulence=False)
    module = FlaxResNet(stage_sizes=STAGES)
    weights = str(root / "model.npz")
    save_variables(weights, module.init(jax.random.key(3), jnp.zeros((1, *IMG, 3)),
                                        train=False))
    common = ["--data_root", str(root / "data"), "--model_name", "resnet50", "--model_path",
              weights, "--img_height", str(IMG[0]), "--img_width", str(IMG[1]),
              "--batch_size", "16", "--compute_dtype", "float32", "--rerank"]
    argv = {"evaluate": ["--targets", "Synthetic"] + common,
            "search": ["--dataset", "Synthetic", "--index_quantize", "int8", "--topk", "5",
                       "--rerank_depth", "16"] + common}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_factory.MODEL_REGISTRY, "resnet50",
                   lambda dtype=jnp.float32, feature="both", **kw: (
                       FlaxResNet(stage_sizes=STAGES, dtype=dtype, feature=feature), 2048))
        mp.setitem(port_factory.MODEL_REGISTRY, "resnet50",
                   lambda dtype, feature="both", **kw: (
                       ResNet50ReID(stage_sizes=STAGES, dtype=dtype, feature=feature), 2048))
        mp.setattr(jax_native_loader, "native_loader_available", lambda: False)
        mp.setattr(port_native_loader, "native_loader_available", lambda: False)
        for package, validate_mod, clis in (
                ("port", port_validate, {"evaluate": port_evaluate, "search": port_search}),
                ("jax", jax_validate, {"evaluate": jax_evaluate, "search": jax_search})):
            for name, cli in clis.items():
                log = []
                mp.setattr(validate_mod.Validator, "rank",
                           _recording(validate_mod.Validator.rank, log))
                extra = ["--device", "cpu"] if package == "port" else []
                out[package, name] = (cli.main(cli.build_argparser().parse_args(
                    argv[name] + extra)), log)
    return out


def test_evaluate_rerank_cli_matches_jax(runs):
    (res_p, log_p), (res_j, log_j) = runs["port", "evaluate"], runs["jax", "evaluate"]
    assert len(log_p) == len(log_j) == 1
    (d_p, cmc_p, map_p), (d_j, cmc_j, map_j) = log_p[0], log_j[0]
    assert d_p.shape == d_j.shape == (8, 24)
    np.testing.assert_allclose(d_p, d_j, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(cmc_p, cmc_j)
    assert abs(map_p - map_j) <= 1e-6
    np.testing.assert_array_equal(res_p["Synthetic"][0], cmc_p)


def test_search_rerank_cli_matches_jax(runs):
    (sims_p, ids_p, pids_p), _ = runs["port", "search"]
    (sims_j, ids_j, pids_j), _ = runs["jax", "search"]
    assert sims_p.shape == (8, 5) and np.isfinite(sims_p).all()
    np.testing.assert_array_equal(pids_p[:, 0], pids_j[:, 0])
    np.testing.assert_allclose(sims_p[:, 0], sims_j[:, 0], rtol=0, atol=1e-4)


@pytest.mark.parametrize("extra", [["--multiple_output"],
                                   ["--model_name", "multipart_resnet50"]])
def test_rerank_with_head_tuples_is_refused(extra):
    args = port_evaluate.build_argparser().parse_args(
        ["--targets", "Synthetic", "--device", "cpu", "--rerank", *extra])
    with pytest.raises(SystemExit, match="--rerank supports single-output"):
        port_evaluate.main(args)
