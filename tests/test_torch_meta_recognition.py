"""Meta-recognition and multi-head evaluation of the port against the JAX package (CPU).

- ``weibull_mle``, ``fit_tail`` / ``wscore`` (FitHigh and FitLow),
  ``metarec`` and ``mrfuse`` of ``daliid_tpu_torch/eval/meta_recognition.py``
  against ``daliid_tpu/eval/meta_recognition.py`` on the same numpy scores,
  both in float32. Tolerances: Weibull shapes and scales rtol 1e-4 (100
  Newton steps whose sums round in another order; a row frozen one step
  earlier or later moves by less than eps = 1e-6 in its shape), CDF weights
  atol 1e-5; ``mrfuse`` atol 1e-4, since its blend divides by the sum of
  three weights that can all be small;
- ``Validator.multihead_distance_matrix``, mean and magnitude weighting,
  against the JAX validator's on the same head embeddings: atol 1e-6;
- ``evaluate --multiple_output`` of both packages on ``multipart_resnet50``
  (flax ``MultiPartResNet50ReID(stage_sizes=(1, 1, 1, 1))`` variables saved
  by ``save_variables``, rebound in both registries; Synthetic, 64x32, f32,
  PIL decode, the JAX CLI on its replicated path), once with the mean
  ensemble and once with ``--head_weighting magnitude --mrfuse``: every
  head's, the ensemble's and the mrfuse ranking's CMC equal and mAP within
  1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daliid_tpu.data.native_loader as jax_native_loader
import daliid_tpu.eval.meta_recognition as jax_mr
import daliid_tpu.eval.validate as jax_validate
import daliid_tpu.models.factory as jax_factory
import daliid_tpu_torch.data.native_loader as port_native_loader
import daliid_tpu_torch.eval.meta_recognition as port_mr
import daliid_tpu_torch.eval.validate as port_validate
import daliid_tpu_torch.models.factory as port_factory
from daliid_tpu.cli import evaluate as jax_evaluate
from daliid_tpu.models.resnet import MultiPartResNet50ReID as FlaxMultiPart
from daliid_tpu.train.checkpoint import save_variables
from daliid_tpu_torch.cli import evaluate as port_evaluate
from daliid_tpu_torch.data import make_synthetic_dataset
from daliid_tpu_torch.models.resnet import MultiPartResNet50ReID

STAGES = (1, 1, 1, 1)
IMG = (64, 32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_weibull_mle_matches_jax():
    rng = np.random.default_rng(0)
    true_k, true_lam = np.array([1.5, 3.0, 0.8, 6.0]), np.array([2.0, 0.5, 4.0, 1.0])
    u = rng.random((4, 3000))
    data = (true_lam[:, None] * (-np.log(u)) ** (1.0 / true_k[:, None])).astype(np.float32)
    k_j, lam_j = jax_mr.weibull_mle(jnp.asarray(data))
    k_p, lam_p = port_mr.weibull_mle(_t(data))
    assert k_p.dtype == lam_p.dtype == torch.float32
    np.testing.assert_allclose(k_p.numpy(), np.asarray(k_j), rtol=1e-4)
    np.testing.assert_allclose(lam_p.numpy(), np.asarray(lam_j), rtol=1e-4)
    np.testing.assert_allclose(k_p.numpy(), true_k, rtol=0.1)


def test_weibull_mle_keeps_unconverged_rows_at_their_last_iterate():
    """Three iterations stop before convergence: every row takes its last
    iterate, as the JAX loop's mask leaves it."""
    data = np.random.default_rng(1).uniform(0.1, 3.0, (5, 200)).astype(np.float32)
    k_j, lam_j = jax_mr.weibull_mle(jnp.asarray(data), iters=3)
    k_p, lam_p = port_mr.weibull_mle(_t(data), iters=3)
    np.testing.assert_allclose(k_p.numpy(), np.asarray(k_j), rtol=1e-5)
    np.testing.assert_allclose(lam_p.numpy(), np.asarray(lam_j), rtol=1e-5)


@pytest.mark.parametrize("sign", [1, -1])
def test_fit_tail_and_wscore_match_jax(sign):
    rng = np.random.default_rng(2)
    data = rng.random((6, 300)).astype(np.float32)
    fit_j = jax_mr.fit_tail(jnp.asarray(data), 50, sign=sign)
    fit_p = port_mr.fit_tail(_t(data), 50, sign=sign)
    assert fit_p.sign == sign and fit_p.translate == 1.0
    np.testing.assert_array_equal(fit_p.small_score.numpy(), np.asarray(fit_j.small_score))
    np.testing.assert_allclose(fit_p.shape.numpy(), np.asarray(fit_j.shape), rtol=1e-4)
    np.testing.assert_allclose(fit_p.scale.numpy(), np.asarray(fit_j.scale), rtol=1e-4)
    scores = rng.random((9, 6)).astype(np.float32)
    for rev in (False, True):
        np.testing.assert_allclose(port_mr.wscore(fit_p, _t(scores), reversed_=rev).numpy(),
                                   np.asarray(jax_mr.wscore(fit_j, jnp.asarray(scores),
                                                            reversed_=rev)), atol=1e-5)


@pytest.mark.parametrize("topk", [5, 20])
def test_metarec_matches_jax(topk):
    sim = (1.0 - 2.0 * np.random.default_rng(3).random((40, 60))).astype(np.float32)
    sim[3, 7] = np.nan  # the reference zeroes NaNs
    got = port_mr.metarec(_t(sim), topk=topk).numpy()
    want = np.asarray(jax_mr.metarec(jnp.asarray(sim), topk=topk))
    assert got.shape == (40, 60) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_mrfuse_matches_jax():
    rng = np.random.default_rng(4)
    sims = [(1.0 - 2.0 * rng.random((40, 60))).astype(np.float32) for _ in range(3)]
    got = port_mr.mrfuse(*map(_t, sims)).numpy()
    want = np.asarray(jax_mr.mrfuse(*sims))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("weighting", ["mean", "magnitude"])
def test_multihead_distance_matrix_matches_jax(weighting):
    rng = np.random.default_rng(5)
    heads = lambda n: tuple((rng.normal(size=(n, 16)) * rng.uniform(0.5, 2, (n, 1)))
                            .astype(np.float32) for _ in range(3))
    q, g = heads(7), heads(11)
    want = jax_validate.Validator(sharded=False).multihead_distance_matrix(q, g, weighting)
    validator = port_validate.Validator(device="cpu")
    got = validator.multihead_distance_matrix(q, g, weighting)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    distmats = [validator.distance_matrix(qh, gh) for qh, gh in zip(q, g)]
    assert torch.equal(validator.multihead_distance_matrix(q, g, weighting, distmats=distmats),
                       got)
    with pytest.raises(ValueError, match="mean|magnitude"):
        validator.multihead_distance_matrix(q, g, "max")


# ---------------------------------------------------------------- the CLI
@pytest.fixture(scope="module")
def multipart_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_multipart")
    make_synthetic_dataset(str(root / "Synthetic"), num_ids=8, imgs_per_id_train=1,
                           imgs_per_id_test=3, with_turbulence=False)
    module = FlaxMultiPart(stage_sizes=STAGES)
    weights = str(root / "multipart.npz")
    save_variables(weights, module.init(jax.random.key(3), jnp.zeros((1, *IMG, 3))))
    return str(root), weights


def _run(multipart_world, extra):
    root, weights = multipart_world
    argv = ["--targets", "Synthetic", "--data_root", root, "--model_name", "multipart_resnet50",
            "--model_path", weights, "--img_height", str(IMG[0]), "--img_width", str(IMG[1]),
            "--batch_size", "16", "--compute_dtype", "float32", "--no-sharded_eval", *extra]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_factory.MODEL_REGISTRY, "multipart_resnet50",
                   lambda dtype=jnp.float32, **kw: (FlaxMultiPart(stage_sizes=STAGES,
                                                                  dtype=dtype), 2048))
        mp.setitem(port_factory.MODEL_REGISTRY, "multipart_resnet50",
                   lambda dtype, **kw: (MultiPartResNet50ReID(stage_sizes=STAGES, dtype=dtype),
                                        2048))
        mp.setattr(jax_native_loader, "native_loader_available", lambda: False)
        mp.setattr(port_native_loader, "native_loader_available", lambda: False)
        for package, validate_mod, cli, dev in (
                ("port", port_validate, port_evaluate, ["--device", "cpu"]),
                ("jax", jax_validate, jax_evaluate, [])):
            log = []
            ranked = validate_mod.Validator.rank

            def rank(self, distmat, queries, gallery, ranked=ranked, log=log):
                cmc, mAP = ranked(self, distmat, queries, gallery)
                log.append((np.asarray(cmc), float(mAP)))
                return cmc, mAP

            mp.setattr(validate_mod.Validator, "rank", rank)
            results = cli.main(cli.build_argparser().parse_args(argv + dev))
            out[package] = (results, log)
    return out


@pytest.mark.parametrize("extra,n_rankings", [
    ([], 5), (["--head_weighting", "magnitude", "--mrfuse"], 6)])
def test_multiple_output_evaluate_matches_jax(multipart_world, extra, n_rankings, capsys):
    out = _run(multipart_world, ["--multiple_output", *extra])
    (res_p, log_p), (res_j, log_j) = out["port"], out["jax"]
    assert list(res_p) == list(res_j)
    assert len(log_p) == len(log_j) == n_rankings  # 4 heads, the ensemble[, mrfuse]
    for i, ((cmc_p, map_p), (cmc_j, map_j)) in enumerate(zip(log_p, log_j)):
        np.testing.assert_array_equal(cmc_p, cmc_j, err_msg=f"ranking {i}")
        assert abs(map_p - map_j) <= 1e-6, i
    for key in res_j:
        np.testing.assert_array_equal(res_p[key][0], np.asarray(res_j[key][0]))
    printed = capsys.readouterr().out
    for tag in (":head0", ":head3", ":ensemble") + ((":mrfuse",) if "--mrfuse" in extra else ()):
        assert f"[Synthetic{tag}] mAP" in printed


def test_evaluate_refuses_what_the_jax_cli_refuses(multipart_world):
    root, _ = multipart_world
    parse = port_evaluate.build_argparser().parse_args
    base = ["--targets", "Synthetic", "--data_root", root, "--device", "cpu",
            "--img_height", str(IMG[0]), "--img_width", str(IMG[1]), "--batch_size", "16"]
    with pytest.raises(SystemExit, match="--head_weighting applies only with --multiple_output"):
        port_evaluate.main(parse(base + ["--model_name", "multipart_resnet50",
                                         "--head_weighting", "magnitude"]))
    with pytest.raises(SystemExit, match="requires a multi-head model"):
        port_evaluate.main(parse(base + ["--model_name", "resnet50", "--multiple_output"]))
