"""The port's fusion and ensemble evaluation against the JAX package (CPU).

- each function of ``daliid_tpu_torch/eval/fusion.py`` against
  ``daliid_tpu/eval/fusion.py`` on the same numpy embeddings: within 1e-6
  (float32; the concatenation's norms and the blend's divisions round in
  another order), the ROC arrays' labels exactly and scores within 1e-7;
- the port's numpy ``roc_curve`` against scikit-learn's ``roc_curve`` (the
  JAX CLI's) on random, tied, all-equal and one-class scores: equal arrays;
- ``evaluate-fusion`` and ``evaluate-ensemble`` of both packages on one
  Synthetic set (8 identities, 64x32 images) with the same two
  differently seeded checkpoints (flax ``ResNet50ReID(stage_sizes=(1, 1, 1,
  1))`` variables saved by the JAX package's ``save_variables``; ``resnet50``
  is rebound to these stage sizes in both registries for the module, and
  both packages decode with PIL): the same tags in the same order, every
  ranking's CMC equal and mAP within 1e-6, and each ranked distmat within
  2e-5 (the two forwards' embeddings differ in float32 summation order,
  about 1e-6 relative); the ``gap`` fusion's ROC files equal scikit-learn's
  arrays on the distmat the port ranked. Each JAX CLI runs once per module.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import roc_curve as sk_roc_curve

import daliid_tpu.data.native_loader as jax_native_loader
import daliid_tpu.eval.fusion as jax_fusion
import daliid_tpu.eval.validate as jax_validate
import daliid_tpu.models.factory as jax_factory
import daliid_tpu_torch.data.native_loader as port_native_loader
import daliid_tpu_torch.eval.fusion as port_fusion
import daliid_tpu_torch.eval.validate as port_validate
import daliid_tpu_torch.models.factory as port_factory
from daliid_tpu.cli import evaluate_ensemble as jax_ensemble
from daliid_tpu.cli import evaluate_fusion as jax_fusion_cli
from daliid_tpu.models.resnet import ResNet50ReID as FlaxResNet
from daliid_tpu.train.checkpoint import save_variables
from daliid_tpu_torch.cli import evaluate_ensemble as port_ensemble
from daliid_tpu_torch.cli import evaluate_fusion as port_fusion_cli
from daliid_tpu_torch.data import make_synthetic_dataset
from daliid_tpu_torch.models.resnet import ResNet50ReID

STAGES = (1, 1, 1, 1)
IMG = (64, 32)
TAGS = ["concat", "clean", "distortion", "average", "magnitude_gap", "magnitude_gmp",
        "magnitude_both"]


# ---------------------------------------------------------------- functions
@pytest.fixture(scope="module")
def emb():
    rng = np.random.default_rng(0)
    f = lambda n, d=48: (rng.normal(size=(n, d)) * rng.uniform(0.5, 3, (n, 1))).astype(np.float32)
    return {"qa": f(9), "qb": f(9, 32), "ga": f(20), "gb": f(20, 32),
            "q_pids": rng.integers(0, 4, 9), "g_pids": rng.integers(0, 4, 20)}


def _t(a):
    return torch.from_numpy(np.array(a))


def test_concat_and_average_match_jax(emb):
    want = jax_fusion.concat_features_distmat(emb["qa"], emb["qb"], emb["ga"], emb["gb"])
    got = port_fusion.concat_features_distmat(_t(emb["qa"]), _t(emb["qb"]), _t(emb["ga"]),
                                              _t(emb["gb"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    d1, d2 = np.asarray(want), np.asarray(want) ** 2
    np.testing.assert_allclose(port_fusion.average_distmats(_t(d1), _t(d2)).numpy(),
                               np.asarray(jax_fusion.average_distmats(d1, d2)), rtol=0, atol=1e-7)


def test_magnitude_weighted_distmat_matches_jax(emb):
    mags = [jax_fusion.magnitude_weights(emb[k]) for k in ("qa", "ga", "qb", "gb")]
    port_mags = [port_fusion.magnitude_weights(_t(emb[k])) for k in ("qa", "ga", "qb", "gb")]
    for m, pm in zip(mags, port_mags):
        assert pm.shape == m.shape and pm.shape[1] == 1
        np.testing.assert_allclose(pm.numpy(), m, rtol=1e-6)
    rng = np.random.default_rng(1)
    da, db = (rng.uniform(0, 2, (9, 20)).astype(np.float32) for _ in range(2))
    want = jax_fusion.magnitude_weighted_distmat(da, db, *mags)
    got = port_fusion.magnitude_weighted_distmat(_t(da), _t(db), *port_mags)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_roc_arrays_match_jax(emb):
    d = np.random.default_rng(2).uniform(0, 2, (9, 20)).astype(np.float32)
    labels, scores = port_fusion.roc_arrays(_t(d), emb["q_pids"], emb["g_pids"])
    want_l, want_s = jax_fusion.roc_arrays(d, emb["q_pids"], emb["g_pids"])
    np.testing.assert_array_equal(labels, want_l)
    np.testing.assert_allclose(scores, want_s, rtol=0, atol=1e-7)


def _roc_cases():
    rng = np.random.default_rng(3)
    yield "random", rng.integers(0, 2, 400), rng.normal(size=400).astype(np.float32)
    yield "ties", rng.integers(0, 2, 400), np.round(rng.normal(size=400), 1).astype(np.float32)
    yield "all equal", rng.integers(0, 2, 30), np.full(30, 0.25, np.float32)
    yield "two points", np.array([0, 1]), np.array([0.1, 0.9])
    yield "collinear", np.array([1, 1, 0, 0, 1, 0]), np.array([6, 5, 4, 3, 2, 1.0])
    yield "no negatives", np.ones(12, int), rng.normal(size=12)
    yield "no positives", np.zeros(12, int), rng.normal(size=12)


@pytest.mark.filterwarnings("ignore::sklearn.exceptions.UndefinedMetricWarning")
@pytest.mark.parametrize("case", [c[0] for c in _roc_cases()])
def test_roc_curve_equals_sklearn(case):
    _, labels, scores = next(c for c in _roc_cases() if c[0] == case)
    want = sk_roc_curve(labels, scores, pos_label=1)
    got = port_fusion.roc_curve(labels, scores)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert np.isinf(got[2][0])


# ---------------------------------------------------------------- the CLIs
def _recording(ranked, log):
    """Wrap ``Validator.rank`` to record each ranking's distmat and result."""

    def rank(self, distmat, queries, gallery):
        cmc, mAP = ranked(self, distmat, queries, gallery)
        d = distmat.cpu().numpy() if torch.is_tensor(distmat) else np.asarray(distmat)
        log.append((d, np.asarray(cmc), float(mAP)))
        return cmc, mAP

    return rank


def _tiny_registries(mp):
    mp.setitem(jax_factory.MODEL_REGISTRY, "resnet50",
               lambda dtype=jnp.float32, feature="both", **kw: (
                   FlaxResNet(stage_sizes=STAGES, dtype=dtype, feature=feature), 2048))
    mp.setitem(port_factory.MODEL_REGISTRY, "resnet50",
               lambda dtype, feature="both", **kw: (
                   ResNet50ReID(stage_sizes=STAGES, dtype=dtype, feature=feature), 2048))
    mp.setattr(jax_native_loader, "native_loader_available", lambda: False)
    mp.setattr(port_native_loader, "native_loader_available", lambda: False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' fusion and ensemble CLIs on one set and one pair of
    checkpoints → {(package, cli): (results, rankings, cwd)}."""
    root = tmp_path_factory.mktemp("torch_fusion")
    make_synthetic_dataset(str(root / "data" / "Synthetic"), num_ids=8, imgs_per_id_train=1,
                           imgs_per_id_test=3, with_turbulence=False)
    paths = []
    for seed in (1, 2):
        module = FlaxResNet(stage_sizes=STAGES)
        variables = module.init(jax.random.key(seed), jnp.zeros((1, *IMG, 3)), train=False)
        paths.append(str(root / f"model{seed}.npz"))
        save_variables(paths[-1], variables)
    common = ["--dataset", "Synthetic", "--data_root", str(root / "data"), "--img_height",
              str(IMG[0]), "--img_width", str(IMG[1]), "--batch_size", "16",
              "--compute_dtype", "float32"]
    argv = {
        "fusion": common + ["--model_path_clean", paths[0], "--model_path_distortion", paths[1],
                            "--roc_version", "t"],
        "ensemble": common + ["--model_path01", paths[0], "--model_path02", paths[1]],
    }
    out = {"argv": argv}
    with pytest.MonkeyPatch.context() as mp:
        _tiny_registries(mp)
        for package, validate_mod, clis in (
                ("port", port_validate, {"fusion": port_fusion_cli, "ensemble": port_ensemble}),
                ("jax", jax_validate, {"fusion": jax_fusion_cli, "ensemble": jax_ensemble})):
            ranked = validate_mod.Validator.rank
            for name, cli in clis.items():
                log = []
                cwd = root / f"{package}_{name}"
                cwd.mkdir()
                mp.chdir(cwd)
                mp.setattr(validate_mod.Validator, "rank", _recording(ranked, log))
                extra = ["--device", "cpu"] if package == "port" else []
                results = cli.main(cli.build_argparser().parse_args(argv[name] + extra))
                out[package, name] = (results, log, cwd)
    return out


@pytest.mark.parametrize("cli", ["fusion", "ensemble"])
def test_cli_matches_jax(runs, cli):
    (res_p, log_p, _), (res_j, log_j, _) = runs["port", cli], runs["jax", cli]
    tags = TAGS if cli == "fusion" else ["model01", "model02", "ensemble"]
    assert list(res_p) == list(res_j) == tags
    assert len(log_p) == len(log_j) == len(tags)
    for tag, (d_p, cmc_p, map_p), (d_j, cmc_j, map_j) in zip(tags, log_p, log_j):
        assert d_p.shape == d_j.shape == (8, 24), tag
        np.testing.assert_allclose(d_p, d_j, rtol=0, atol=2e-5, err_msg=tag)
        np.testing.assert_array_equal(cmc_p, cmc_j, err_msg=tag)
        assert abs(map_p - map_j) <= 1e-6, tag
        assert res_p[tag]["rank1"] == cmc_p[0] and res_p[tag]["mAP"] == map_p


def test_fusion_models_differ_so_no_fusion_degenerates(runs):
    _, log, _ = runs["port", "fusion"]
    d_clean, d_dist = log[1][0], log[2][0]
    assert np.abs(d_clean - d_dist).max() > 1e-2


def test_fusion_roc_files_equal_sklearn(runs):
    _, log, cwd = runs["port", "fusion"]
    fused_gap = log[TAGS.index("magnitude_gap")][0]
    splits = port_fusion_cli.load_dataset("Synthetic", root=str(cwd.parent / "data"))
    labels, scores = port_fusion.roc_arrays(fused_gap, splits["query"].pids,
                                            splits["gallery"].pids)
    want = sk_roc_curve(labels, scores, pos_label=1)
    for name, w in zip(("FPR", "TPR", "Thresholds"), want):
        np.testing.assert_array_equal(np.load(os.path.join(cwd, f"{name}_t.npy")), w)


def test_commands_and_refusals():
    from daliid_tpu_torch.__main__ import COMMANDS

    assert COMMANDS["evaluate-fusion"][0] == "cli.evaluate_fusion"
    assert COMMANDS["evaluate-ensemble"][0] == "cli.evaluate_ensemble"
    for cli, base in ((port_fusion_cli, []), (port_ensemble, [])):
        parse = cli.build_argparser().parse_args
        for extra in (["--train_file_path", "x"], ["--multihost"]):
            with pytest.raises(SystemExit, match=f"{extra[0]} is not yet ported"):
                cli.main(parse(["--dataset", "Synthetic", "--device", "cpu", *base, *extra]))
        with pytest.raises(SystemExit, match="BRIAR.*not yet ported"):
            cli.main(parse(["--dataset", "BRIAR", "--device", "cpu"]))


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the int8 CPU path's many small ops: beside
    the other workers of a parallel test run, OpenMP's eight threads a
    worker oversubscribe the cores and an int8 CLI run takes minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cli", ["fusion", "ensemble"])
def test_cli_runs_int8_extraction(runs, cli, monkeypatch, tmp_path, one_torch_thread):
    """``--quantize int8 --calib_batches 2``: one int8 extractor a model,
    pooling and split in fusion (12; the 8 queries are one batch of 16, the
    24 gallery images two, so 18 calibration batches), one a model in
    ensemble (2, each calibrated on the queries' one batch); the same tags
    as the float32 run, and every ranked distmat within 1e-2 of its float32
    counterpart (int8 against float32 embeddings; measured at most 2.3e-3)."""
    from daliid_tpu_torch.eval.features import FeatureExtractor

    calibrations = []  # the extractor of each calibration batch (kept alive)
    calibrate = FeatureExtractor.calibrate

    def counting(self, images_u8, camera_ids=None, rebuild=True):
        calibrations.append(self)
        return calibrate(self, images_u8, camera_ids, rebuild)

    _tiny_registries(monkeypatch)
    monkeypatch.setattr(FeatureExtractor, "calibrate", counting)
    log = []
    monkeypatch.setattr(port_validate.Validator, "rank",
                        _recording(port_validate.Validator.rank, log))
    monkeypatch.chdir(tmp_path)
    mod = port_fusion_cli if cli == "fusion" else port_ensemble
    results = mod.main(mod.build_argparser().parse_args(
        runs["argv"][cli] + ["--device", "cpu", "--quantize", "int8", "--calib_batches", "2"]))
    _, log_fp, _ = runs["port", cli]
    assert list(results) == list(runs["port", cli][0])
    assert len({id(e) for e in calibrations}) == (12 if cli == "fusion" else 2)
    assert len(calibrations) == (18 if cli == "fusion" else 2)
    assert all(e.quantize == "int8" and e._calib_final for e in calibrations)
    for (d_q, _, _), (d_f, _, _) in zip(log, log_fp):
        np.testing.assert_allclose(d_q, d_f, rtol=0, atol=1e-2)


def test_pooling_switch_leaves_the_shared_module_alone():
    """The pooled copy shares the parameters and flips only its own
    ``feature``."""
    bundle = port_factory.get_model("resnet50_gap", img_size=IMG)
    assert bundle.module.feature == "gap"
    pooled = port_fusion_cli.with_pooling(bundle, "gmp")
    assert pooled.module.feature == "gmp" and bundle.module.feature == "gap"
    assert pooled.module.last_bn.weight is bundle.module.last_bn.weight
    assert port_fusion_cli.with_pooling(bundle, "gap") is bundle
