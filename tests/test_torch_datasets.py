"""Datasets and targets of the port against the JAX package (CPU).

On generated trees and manifests (no dataset is downloaded: every layout
is written in the format its parser reads, with small JPEGs):

- every registered loader of both packages (the 11 datasets) gives the same
  splits: paths, pids, camids, kinds and name equal, list-valued splits
  split for split; ``parse_manifest`` and ``load_text_dataset`` likewise;
- ``turbulence_path`` in both naming schemes, equal to the JAX function;
- ``dataset_statistics`` gives the JAX package's ``tabulate`` string, for
  single- and multi-split targets, and ``python -m daliid_tpu_torch stats``
  prints it with ``tabulate`` blocked (``sys.modules["tabulate"] = None``);
- ``load_briar_manifests`` and ``load_eval_splits`` equal to JAX, with
  close-range probes, probe-only identities and disjoint camera strings,
  and the same refusals;
- ``FeatureExtractor.extract(turbulence_dir=...)`` against the JAX
  extractor on one tiny weight set carried across (flax
  ``ResNet50ReID(stage_sizes=(1, 1, 1, 1))``): within 1e-5 of the largest
  embedding entry (float32 summation order); the train sampler's paths for
  ``MSMT17``, ``Market,MSMT17`` and ``MSMT17,Market`` equal to the JAX
  sampler's at one seed;
- ``msmt17_balanced_accuracy`` exactly equal to JAX on the same features,
  and ``MSMT17Validator``'s best tracking and snapshot names;
- ``evaluate`` (MSMT17 with ``--turbulence_dir_path``, PRCC with keys
  ``PRCC:q0..q2``, BRIAR manifests), ``evaluate-ensemble`` and
  ``evaluate-fusion`` on the BRIAR manifests, and ``search --dataset
  MSMT17``, of both packages on the same data and weights (``resnet50``
  rebound to the tiny ResNet in both registries, both decoding with PIL,
  the JAX evaluate on its replicated path): the tolerance of
  ``tests/test_torch_fusion.py``'s CLI parity, every ranked distmat within
  2e-5, every CMC equal and every mAP within 1e-6;
- ``train --dataset MSMT17 --kind_of_transform 1`` reads the pid-prefixed
  turbulence copies (the only ones the tree has) and prints the balanced
  accuracy of the val split after its validation.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daliid_tpu.data.native_loader as jax_native_loader
import daliid_tpu.data.registry as jax_registry
import daliid_tpu.eval.validate as jax_validate
import daliid_tpu.models.factory as jax_factory
import daliid_tpu_torch.data.native_loader as port_native_loader
import daliid_tpu_torch.data.registry as port_registry
import daliid_tpu_torch.eval.validate as port_validate
import daliid_tpu_torch.models.factory as port_factory
from daliid_tpu.cli import evaluate as jax_evaluate
from daliid_tpu.cli import evaluate_ensemble as jax_ensemble
from daliid_tpu.cli import evaluate_fusion as jax_fusion
from daliid_tpu.cli import search as jax_search
from daliid_tpu.data.briar import load_briar_manifests as jax_load_briar
from daliid_tpu.data.briar import load_eval_splits as jax_load_eval_splits
from daliid_tpu.data.turbulence import turbulence_path as jax_turbulence_path
from daliid_tpu.eval.features import FeatureExtractor as JaxExtractor
from daliid_tpu.models.factory import ModelBundle as JaxBundle
from daliid_tpu.models.resnet import ResNet50ReID as FlaxResNet
from daliid_tpu.train.checkpoint import save_variables
from daliid_tpu.train.sampler import PKBatchSampler as JaxSampler
from daliid_tpu_torch.cli import evaluate as port_evaluate
from daliid_tpu_torch.cli import evaluate_ensemble as port_ensemble
from daliid_tpu_torch.cli import evaluate_fusion as port_fusion
from daliid_tpu_torch.cli import search as port_search
from daliid_tpu_torch.data import (
    load_briar_manifests,
    load_eval_splits,
    make_synthetic_dataset,
    turbulence_path,
)
from daliid_tpu_torch.data.synthetic import (
    _identity_image,
    make_briar_manifests,
    make_msmt17_tree,
    make_prcc_tree,
)
from daliid_tpu_torch.eval.features import FeatureExtractor, extract_features
from daliid_tpu_torch.models.factory import ModelBundle
from daliid_tpu_torch.models.resnet import ResNet50ReID
from daliid_tpu_torch.models.torch_port import variables_from_jax
from daliid_tpu_torch.train.sampler import PKBatchSampler

REPO = Path(__file__).resolve().parents[1]
STAGES = (1, 1, 1, 1)
IMG = (64, 32)
DATASETS = ["Market", "Duke", "MSMT17", "Veri", "Veri-Wild", "DeepChange", "PRCC",
            "VC-Clothes", "Celeb-ReID", "ImageNet", "Synthetic"]


# ---------------------------------------------------------------- trees
def _jpeg(path, pid, cam, rng) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _identity_image(rng, pid, cam, 32, 16).save(path, quality=92)
    return str(path)


def _manifest(path, rows) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.writelines(f"{p} {pid} {cam} {kind}\n" for p, pid, cam, kind in rows)


def _manifest_rows(root, rng, n_ids, kind="person", per_id=2, pid0=0):
    return [(_jpeg(os.path.join(root, f"{pid0 + pid}_{i}.jpg"), pid0 + pid, i + 1, rng),
             pid0 + pid, i + 1 + pid % 3, kind) for pid in range(n_ids) for i in range(per_id)]


def make_trees(root: str) -> None:
    """Every registered layout under ``root`` (Synthetic is generated by its
    loader on first use)."""
    rng = np.random.default_rng(0)
    for base in ("Market-1501-v15.09.15", "DukeMTMC-reID"):
        make_synthetic_dataset(os.path.join(root, base), num_ids=3, imgs_per_id_train=2,
                               imgs_per_id_test=2, height=32, width=16, with_turbulence=False)
        junk = os.path.join(root, base, "bounding_box_test")
        _jpeg(os.path.join(junk, "-1_c2s1_000009.jpg"), 0, 2, rng)
        Path(junk, "readme.txt").write_text("not an image")
    make_msmt17_tree(root, train_ids=4, imgs_per_train_id=3, test_ids=4, gallery_per_id=2,
                     height=32, width=16)
    make_prcc_tree(root, train_ids=3, test_ids=4, imgs_per_id=1, height=32, width=16)
    for split in ("image_train", "image_test", "image_query"):  # VeRi: multi-digit cameras
        d = os.path.join(root, "VeRi", split)
        for pid in range(1, 4):
            _jpeg(os.path.join(d, f"{pid:04d}_c{10 + pid:03d}_{pid:08d}_0.jpg"), pid, 1, rng)
        _jpeg(os.path.join(d, "-1_c001_00000001_0.jpg"), 0, 1, rng)
    vw = os.path.join(root, "VeRI-Wild")
    for name in ("train_list_start0.txt", "test_10000_id.txt", "test_10000_id_query.txt"):
        lines = []
        for pid in range(2):
            sub = f"{pid:05d}/{name[:5]}{pid:06d}.jpg"
            _jpeg(os.path.join(vw, "images", sub), pid, 1, rng)
            lines.append(f"{sub} {pid + 7} {pid + 20}\n")
        os.makedirs(os.path.join(vw, "train_test_split"), exist_ok=True)
        Path(vw, "train_test_split", name).write_text("".join(lines) + "\n")
    dc = os.path.join(root, "DeepChange")
    for list_file, split in (("train-set-bbox.txt", "train-set"),
                             ("test-set-gallery-bbox.txt", "test-set-gallery"),
                             ("test-set-query-bbox.txt", "test-set-query")):
        lines = []
        for pid in range(1, 4):
            img = f"P{pid:05d}_C{pid + 1:02d}_D01_H09_{split}.jpg"
            _jpeg(os.path.join(dc, split, img), pid, 1, rng)
            lines.append(f"{img},{100 + 3 * pid}\n")
        os.makedirs(dc, exist_ok=True)
        Path(dc, list_file).write_text("".join(lines))
    cc = os.path.join(root, "ClothesChanging")
    for sub, names in (("VC-Clothes", ("train", "gallery", "query")),
                       ("Real28", ("gallery", "query"))):
        for i, name in enumerate(names):
            _manifest(os.path.join(cc, sub, f"{name}_file.txt"),
                      _manifest_rows(os.path.join(cc, sub, name), rng, 2 + i))
    cb = os.path.join(root, "Celeb-reID", "Celeb-reID")
    for i, name in enumerate(("train", "gallery", "query")):
        _manifest(os.path.join(cb, f"{name}_file.txt"),
                  _manifest_rows(os.path.join(cb, name), rng, 2 + i))
    im = os.path.join(root, "ImageNet")
    for name in ["train_file", "val_file"] + [f"{s}_file{i}" for s in ("gallery", "query")
                                              for i in range(1, 11)]:
        _manifest(os.path.join(im, f"{name}.txt"),
                  _manifest_rows(os.path.join(im, name), rng, 2, kind="object", per_id=1))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_datasets")
    make_trees(str(root / "data"))
    briar = make_briar_manifests(str(root / "briar"), train_ids=3, test_ids=4,
                                 height=32, width=16)
    return {"root": root, "data": str(root / "data"), "briar": briar,
            "turbulence": str(root / "data" / "MSMT17_V2" / "turbulence")}


def _assert_tables_equal(port, jax_t, what):
    assert port.name == jax_t.name, what
    assert list(port.paths) == list(jax_t.paths), what
    for field in ("pids", "camids"):
        got, want = getattr(port, field), getattr(jax_t, field)
        assert got.dtype == want.dtype == np.int64, what
        np.testing.assert_array_equal(got, want, err_msg=f"{what} {field}")
    assert list(port.kinds) == list(jax_t.kinds), what


def _assert_splits_equal(port, jax_s, what):
    assert sorted(port) == sorted(jax_s), what
    for k in port:
        p, j = port[k], jax_s[k]
        assert isinstance(p, list) == isinstance(j, list), (what, k)
        for i, (pt, jt) in enumerate(zip(p, j) if isinstance(p, list) else [(p, j)]):
            _assert_tables_equal(pt, jt, f"{what} {k}[{i}]")
        if isinstance(p, list):
            assert len(p) == len(j), (what, k)


# ---------------------------------------------------------------- registry
@pytest.mark.parametrize("name", DATASETS)
def test_registered_loader_matches_jax(trees, name):
    port = port_registry.load_dataset(name, root=trees["data"])
    want = jax_registry.load_dataset(name, root=trees["data"])
    _assert_splits_equal(port, want, name)
    tables = [t for v in port.values() for t in (v if isinstance(v, list) else [v])]
    assert all(len(t) > 0 for t in tables), name


def test_registry_knows_every_jax_dataset_and_refuses_others():
    assert set(port_registry._LOADERS) == set(jax_registry._LOADERS) == set(DATASETS)
    with pytest.raises(KeyError, match="unknown dataset 'NoSuchDataset'"):
        port_registry.load_dataset("NoSuchDataset")


def test_multi_split_layouts(trees):
    prcc = port_registry.load_dataset("PRCC", root=trees["data"])
    assert len(prcc["gallery"]) == 10 and len(prcc["query"]) == 3
    q_b, q_c, q_bc = prcc["query"]
    assert len(q_bc) == len(q_b) + len(q_c)
    assert set(q_b.camids) == {2} and set(q_c.camids) == {3}
    msmt = port_registry.load_dataset("MSMT17", root=trees["data"])
    assert set(msmt) == {"train", "val", "gallery", "query"}
    assert set(msmt["val"].pids) <= set(msmt["train"].pids)
    vc = port_registry.load_dataset("VC-Clothes", root=trees["data"])
    assert len(vc["gallery"]) == len(vc["query"]) == 2  # VC-Clothes and Real28


def test_parse_manifest_matches_jax(tmp_path):
    f = tmp_path / "list.txt"
    f.write_text("/a/x.jpg 3 1 person\n\n/a/y.jpg 4 -2 object\n")
    got = port_registry.parse_manifest(str(f))
    _assert_tables_equal(got, jax_registry.parse_manifest(str(f)), "manifest")
    assert got.pids.tolist() == [3, 4] and got.camids.tolist() == [1, -2]
    assert got.kinds.tolist() == ["person", "object"]


def test_load_text_dataset_matches_jax(tmp_path):
    for split, rows in (("training", ["7 100", "7 101", "9 102"]), ("query", ["7 200"]),
                        ("gallery", ["9 300", "", "7 301"])):
        (tmp_path / f"{split}_tweets.txt").write_text("\n".join(rows) + "\n")
    got = port_registry.load_text_dataset("/tweets", str(tmp_path))
    want = jax_registry.load_text_dataset("/tweets", str(tmp_path))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == object
        np.testing.assert_array_equal(g, w)
    assert got[1].tolist() == [["/tweets/9/tweets.json", "9", "300"],
                               ["/tweets/7/tweets.json", "7", "301"]]


def test_merge_and_multiple_datasets_match_jax(trees):
    names = ["MSMT17", "PRCC", "Market"]
    port = port_registry.load_multiple_datasets(names, root=trees["data"])
    want = jax_registry.load_multiple_datasets(names, root=trees["data"])
    for n, p, w in zip(names, port, want):
        _assert_splits_equal(p, w, n)
    _assert_tables_equal(port_registry.merge_train_tables([s["train"] for s in port]),
                         jax_registry.merge_train_tables([s["train"] for s in want]), "merged")


# ---------------------------------------------------------------- turbulence
def test_turbulence_path_both_schemes():
    p = turbulence_path("/d/0001_010_05_0303morning_0015_1.jpg", "/turb", 3, dataset="MSMT17")
    assert p == "/turb/0001_0001_010_05_0303morning_0015_1_turbstrength3.jpg"
    assert turbulence_path("/d/0001_c1s1_0.jpg", "/turb", 5) == "/turb/0001_c1s1_0_turbstrength5.jpg"
    for path in ("/d/0001_c1s1_0.jpg", "/x/0042/0042_000_12_0303noon_0001_0.jpg", "/y/noext",
                 "rel/a.b.c.png"):
        for dataset in (None, "Market", "MSMT17", "PRCC"):
            for s in (1, 5):
                assert (turbulence_path(path, "/t", s, dataset)
                        == jax_turbulence_path(path, "/t", s, dataset))


def test_generated_msmt17_copies_follow_its_scheme_only(trees):
    msmt = port_registry.load_dataset("MSMT17", root=trees["data"])
    for p in list(msmt["train"].paths) + list(msmt["gallery"].paths):
        for s in range(1, 6):
            assert os.path.exists(turbulence_path(p, trees["turbulence"], s, "MSMT17"))
            assert not os.path.exists(turbulence_path(p, trees["turbulence"], s))


# ---------------------------------------------------------------- statistics
@pytest.mark.parametrize("names", [["Market"], ["MSMT17", "Veri-Wild"], ["PRCC"],
                                   ["Market", "ImageNet", "VC-Clothes", "Celeb-ReID"]])
def test_dataset_statistics_equals_jax(trees, names):
    got = port_registry.dataset_statistics(names, root=trees["data"])
    assert got == jax_registry.dataset_statistics(names, root=trees["data"])
    assert got.splitlines()[0].startswith("Dataset")


def test_simple_table_equals_tabulate_on_ragged_widths():
    from tabulate import tabulate

    rng = np.random.default_rng(1)
    for _ in range(50):
        rows = [[str(rng.choice(["M", "PRCC:q0", "averyveryverylongname"]))]
                + [("-" if rng.random() < 0.3 else int(rng.integers(0, 10 ** rng.integers(1, 12))))
                   for _ in range(9)] for _ in range(int(rng.integers(0, 5)))]
        assert (port_registry.simple_table(rows, port_registry.STATS_HEADERS)
                == tabulate(rows, headers=port_registry.STATS_HEADERS))


def test_stats_command_runs_without_tabulate(trees):
    names = ["Market", "PRCC"]
    probe = ("import runpy, sys; sys.modules['tabulate'] = None; "
             "sys.argv = ['daliid_tpu_torch'] + sys.argv[1:]; "
             "runpy.run_module('daliid_tpu_torch', run_name='__main__')")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", probe, "stats", "--targets", *names,
                        "--data_root", trees["data"]], cwd=trees["root"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout == jax_registry.dataset_statistics(names, root=trees["data"]) + "\n"


def test_port_sources_import_no_tabulate():
    hits = [str(f) for f in (REPO / "daliid_tpu_torch").rglob("*.py")
            if "import tabulate" in f.read_text() or "from tabulate" in f.read_text()]
    assert not hits, hits


# ---------------------------------------------------------------- BRIAR
def _npy(tmp_path, name, rows):
    path = tmp_path / f"{name}.npy"
    np.save(path, np.array(rows, dtype=object), allow_pickle=True)
    return str(path)


def test_briar_manifests_match_jax(trees):
    b = trees["briar"]
    got = load_briar_manifests(b["train"], b["queries"], b["gallery"])
    want = jax_load_briar(b["train"], b["queries"], b["gallery"])
    for g, w, split in zip(got, want, ("train", "query", "gallery")):
        _assert_tables_equal(g, w, split)
    _, query, gallery = got
    raw = np.load(b["queries"], allow_pickle=True)
    kept = [r for r in raw if "range" not in r[3] and r[1] not in ("G00900", "G00901")]
    assert list(query.paths) == [r[0] for r in kept]  # close-range and probe-only dropped
    # disjoint camera strings → disjoint indices in one shared map
    assert not set(query.camids) & set(gallery.camids)
    assert set(query.pids) <= set(gallery.pids)


def test_briar_ingest(tmp_path):
    train = _npy(tmp_path, "t", [["/a/1.jpg", "Gp1", "c1", "200m"],
                                 ["/a/2.jpg", "Gp2", "c2", "400m"]])
    queries = _npy(tmp_path, "q", [["/q/1.jpg", "Gp1", "c1", "200m"],
                                   ["/q/2.jpg", "Gp1", "c1", "close_range"],
                                   ["/q/3.jpg", "Gp9", "c1", "200m"]])
    gallery = _npy(tmp_path, "g", [["/g/1.jpg", "Gp1", "c3", "200m"],
                                   ["/g/2.jpg", "Gp2", "c3", "500m"]])
    t, q, g = load_briar_manifests(train, queries, gallery)
    for got, want in zip((t, q, g), jax_load_briar(train, queries, gallery)):
        _assert_tables_equal(got, want, "briar")
    assert len(q) == 1 and len(g) == 2 and len(t) == 2
    assert q.pids[0] == g.pids[0]
    assert q.camids[0] != g.camids[0] and g.camids[0] == g.camids[1]


def test_briar_disjoint_cameras_rank(tmp_path):
    """A probe at camera c1 whose only true match sits at gallery camera c3
    ranks first (no junk filtering across the shared camera map)."""
    from daliid_tpu_torch.metrics.ranking import evaluate_rank

    t = _npy(tmp_path, "t", [["/a/1.jpg", "Gp1", "c1", "200m"]])
    qp = _npy(tmp_path, "q", [["/q/1.jpg", "Gp1", "c1", "200m"]])
    gp = _npy(tmp_path, "g", [["/g/1.jpg", "Gp1", "c3", "200m"], ["/g/2.jpg", "Gp2", "c3", "200m"]])
    _, q, g = load_briar_manifests(t, qp, gp)
    cmc, mAP = evaluate_rank(np.array([[0.1, 0.9]], np.float32), q.pids, g.pids, q.camids,
                             g.camids)
    assert cmc[0] == pytest.approx(1.0) and mAP == pytest.approx(1.0)


@pytest.mark.parametrize("case", ["partial", "briar_without", "manifests_elsewhere"])
def test_load_eval_splits_refusals_match_jax(trees, case):
    b = trees["briar"]
    kw = {"partial": ("BRIAR", {"train_npy": b["train"]}, "given together"),
          "briar_without": ("BRIAR", {}, "requires"),
          "manifests_elsewhere": ("Market", {"train_npy": b["train"], "queries_npy": b["queries"],
                                             "gallery_npy": b["gallery"]}, "BRIAR dataset only")}
    dataset, paths, match = kw[case]
    for load in (load_eval_splits, jax_load_eval_splits):
        with pytest.raises(SystemExit, match=match):
            load(dataset, root=trees["data"], **paths)


def test_load_eval_splits_reads_both_kinds(trees):
    b = trees["briar"]
    got = load_eval_splits("BRIAR", train_npy=b["train"], queries_npy=b["queries"],
                           gallery_npy=b["gallery"])
    want = jax_load_eval_splits("BRIAR", train_npy=b["train"], queries_npy=b["queries"],
                                gallery_npy=b["gallery"])
    _assert_splits_equal(got, want, "BRIAR")
    _assert_splits_equal(load_eval_splits("PRCC", root=trees["data"]),
                         jax_load_eval_splits("PRCC", root=trees["data"]), "PRCC")


# ---------------------------------------------------------------- extraction
@pytest.fixture(scope="module")
def weights(trees):
    """One tiny flax ResNet's variables → (npz path, JAX bundle, port bundle)."""
    module = FlaxResNet(stage_sizes=STAGES)
    variables = jax.device_get(module.init(jax.random.key(5), jnp.zeros((1, *IMG, 3)),
                                           train=False))
    path = str(trees["root"] / "tiny_resnet.npz")
    save_variables(path, variables)
    port = ResNet50ReID(stage_sizes=STAGES).eval()
    port.load_state_dict(variables_from_jax("resnet50", variables), strict=True)
    return (path, JaxBundle(module=module, variables=variables, feature_dim=2048,
                            name="resnet50"),
            ModelBundle(module=port, feature_dim=2048, name="resnet50"))


@pytest.fixture
def pil_only(monkeypatch):
    monkeypatch.setattr(jax_native_loader, "native_loader_available", lambda: False)
    monkeypatch.setattr(port_native_loader, "native_loader_available", lambda: False)


def test_extract_turbulence_gallery_matches_jax(trees, weights, pil_only):
    _, jax_bundle, port_bundle = weights
    gallery = port_registry.load_dataset("MSMT17", root=trees["data"])["gallery"]
    jax_gallery = jax_registry.load_dataset("MSMT17", root=trees["data"])["gallery"]
    port_ex = FeatureExtractor(port_bundle, img_size=IMG, batch_size=16, device="cpu")
    jax_ex = JaxExtractor(jax_bundle, img_size=IMG, batch_size=16)
    got = port_ex.extract(gallery, turbulence_dir=trees["turbulence"], turb_strength=2)
    want = jax_ex.extract(jax_gallery, turbulence_dir=trees["turbulence"], turb_strength=2)
    assert got.shape == want.shape == (len(gallery), 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    clean = port_ex.extract(gallery)
    assert np.abs(clean - got).max() > 1e-3 * np.abs(got).max()  # the copies were read
    # the dataset argument wins over the table's name: Market names do not exist here
    with pytest.raises(FileNotFoundError):
        port_ex.extract(gallery, turbulence_dir=trees["turbulence"], turb_strength=2,
                        dataset="Market")
    paths = [str(p) for p in gallery.paths[:3]]
    np.testing.assert_allclose(
        port_ex.extract(paths, turbulence_dir=trees["turbulence"], turb_strength=2,
                        dataset="MSMT17"), got[:3], rtol=0, atol=1e-6 * np.abs(got).max())
    one_shot = extract_features(gallery, port_bundle, img_size=IMG, batch_size=16,
                                device="cpu", turbulence_dir=trees["turbulence"],
                                turb_strength=2)
    np.testing.assert_allclose(one_shot, got, rtol=0, atol=1e-6 * np.abs(got).max())


def test_eval_config_is_the_jax_one_plus_device():
    from daliid_tpu.config import EvalConfig as JaxEvalConfig
    from daliid_tpu_torch.config import EvalConfig

    fields = [(f.name, f.default) for f in dataclasses.fields(EvalConfig)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(JaxEvalConfig)] + [
        ("device", "cuda")]
    assert EvalConfig(img_height=64, img_width=32).img_size == (64, 32)


@pytest.mark.parametrize("dataset", ["MSMT17", "Market,MSMT17", "MSMT17,Market"])
def test_sampler_turbulence_paths_match_jax(trees, dataset):
    """The sampler names every row's copy by the first dataset of the list,
    as the JAX train CLI does (``dataset=names[0]``): for ``Market,MSMT17``
    the MSMT17 rows look for Market-named copies, for ``MSMT17,Market`` the
    Market rows for pid-prefixed ones."""
    names = dataset.split(",")
    tables = {}
    for pkg, reg in (("port", port_registry), ("jax", jax_registry)):
        tables[pkg] = reg.merge_train_tables(
            [reg.load_dataset(n, root=trees["data"])["train"] for n in names])
    kw = dict(P=3, K=2, kind_of_transform=1, turbulence_dir=trees["turbulence"],
              dataset=names[0], seed=7)
    mine = PKBatchSampler(tables["port"], tables["port"].pids, **kw)
    theirs = JaxSampler(tables["jax"], tables["jax"].pids, **kw)
    n_batches, msmt17_pairs = 0, []
    for a, b in zip(mine.epoch(), theirs.epoch()):
        assert a.paths == b.paths
        np.testing.assert_array_equal(a.distortions, b.distortions)
        msmt17_pairs += [(c, t) for c, t in zip(a.paths[::2], a.paths[1::2]) if "MSMT17_V2" in c]
        n_batches += 1
    assert n_batches == mine.batches_per_epoch() > 0
    # the tree holds MSMT17-named copies only: found iff MSMT17 names the list
    assert msmt17_pairs
    assert all(os.path.exists(t) == (names[0] == "MSMT17") for _, t in msmt17_pairs)
    # the default naming is the table's: the merged table keeps the first name
    assert PKBatchSampler(tables["port"], tables["port"].pids, P=3, K=2, kind_of_transform=1,
                          turbulence_dir="/turb").dataset == names[0]


# ---------------------------------------------------------------- MSMT17 validation
def _fixed(cls, feats):
    """An extractor of ``cls`` that returns planted features by path."""

    class Fixed(cls):
        def __init__(self):
            pass

        def extract(self, table, *args, **kw):
            return np.stack([feats[str(p)] for p in table.paths])

    return Fixed()


@pytest.fixture(scope="module")
def msmt_features(trees):
    splits = port_registry.load_dataset("MSMT17", root=trees["data"])
    rng = np.random.default_rng(3)
    paths = [str(p) for t in (splits["train"], splits["val"]) for p in t.paths]
    feats = {p: rng.normal(size=8).astype(np.float32) for p in paths}
    # a val row equidistant from two centers: argmax breaks the tie alike
    feats[paths[-1]] = np.zeros(8, np.float32)
    return splits, feats


def test_msmt17_balanced_accuracy_equals_jax(msmt_features):
    splits, feats = msmt_features
    for seed in range(4):
        f = {p: v + np.float32(0.3 * seed) * np.sign(v) for p, v in feats.items()}
        got = port_validate.msmt17_balanced_accuracy(
            splits["train"], splits["val"], _fixed(FeatureExtractor, f), verbose=False)
        want = jax_validate.msmt17_balanced_accuracy(
            splits["train"], splits["val"], _fixed(JaxExtractor, f), verbose=False)
        assert got == want and 0.0 <= got <= 1.0


def test_msmt17_validator_tracks_the_best_and_names_its_snapshots(msmt_features, tmp_path):
    splits, feats = msmt_features
    train, val = splits["train"], splits["val"]
    pid_of = {str(p): int(pid) for t in (train, val) for p, pid in zip(t.paths, t.pids)}
    good = {p: np.eye(8, dtype=np.float32)[pid_of[p]] for p in feats}  # accuracy 1
    port_v = port_validate.MSMT17Validator(train, val, save_dir=str(tmp_path / "port"),
                                           model_name="resnet50", version="v3")
    jax_v = jax_validate.MSMT17Validator(train, val, save_dir=str(tmp_path / "jax"),
                                         model_name="resnet50", version="v3")
    state = {"w": torch.ones(2)}
    variables = {"params": {"w": np.ones(2, np.float32)}}
    for it, (online, momentum) in enumerate([(feats, feats), (good, feats), (feats, feats)], 1):
        got = port_v.validate(it, _fixed(FeatureExtractor, online),
                              _fixed(FeatureExtractor, momentum), state, state, verbose=False)
        want = jax_v.validate(it, _fixed(JaxExtractor, online), _fixed(JaxExtractor, momentum),
                              variables, variables, verbose=False)
        assert got == want
        assert (port_v.best_accuracy, port_v.best_iter) == (jax_v.best_accuracy, jax_v.best_iter)
    assert port_v.best_accuracy == 1.0 and port_v.best_iter == 2
    stems = ["model_momentum_bestACC_resnet50_v3", "model_online_bestACC_resnet50_v3"]
    assert sorted(f.name for f in (tmp_path / "port").iterdir()) == [s + ".pt" for s in stems]
    assert sorted(f.name for f in (tmp_path / "jax").iterdir()) == [s + ".npz" for s in stems]
    assert torch.equal(torch.load(tmp_path / "port" / (stems[1] + ".pt"))["w"], state["w"])


# ---------------------------------------------------------------- the CLIs
def _recording(ranked, log):
    def rank(self, distmat, queries, gallery):
        cmc, mAP = ranked(self, distmat, queries, gallery)
        d = distmat.cpu().numpy() if torch.is_tensor(distmat) else np.asarray(distmat)
        log.append((d, np.asarray(cmc), float(mAP)))
        return cmc, mAP

    return rank


@pytest.fixture(scope="module")
def runs(trees, weights):
    """Both packages' CLIs on the generated data and one weight set →
    {(package, run): (result, rankings)}."""
    path = weights[0]
    b = trees["briar"]
    manifests = ["--train_file_path", b["train"], "--queries_file_path", b["queries"],
                 "--gallery_file_path", b["gallery"]]
    shape = ["--data_root", trees["data"], "--img_height", str(IMG[0]), "--img_width",
             str(IMG[1]), "--batch_size", "16", "--compute_dtype", "float32"]
    argv = {
        "evaluate_msmt17": (port_evaluate, jax_evaluate, [
            "--targets", "MSMT17", "--model_path", path, "--turbulence_dir_path",
            trees["turbulence"], "--turbulence_strength", "2", "--no-sharded_eval", *shape]),
        "evaluate_prcc_briar": (port_evaluate, jax_evaluate, [
            "--targets", "PRCC", "BRIAR", "--model_path", path, "--no-sharded_eval",
            *manifests, *shape]),
        "ensemble_briar": (port_ensemble, jax_ensemble, [
            "--dataset", "BRIAR", "--model_path01", path, "--model_path02", path, *manifests,
            *shape]),
        "fusion_briar": (port_fusion, jax_fusion, [
            "--dataset", "BRIAR", "--model_path_clean", path, "--model_path_distortion", path,
            *manifests, *shape]),
        "search_msmt17": (port_search, jax_search, [
            "--dataset", "MSMT17", "--model_path", path, "--topk", "5", *shape]),
    }
    out = {}
    ranked = {"port": port_validate.Validator.rank, "jax": jax_validate.Validator.rank}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_factory.MODEL_REGISTRY, "resnet50",
                   lambda dtype=jnp.float32, feature="both", **kw: (
                       FlaxResNet(stage_sizes=STAGES, dtype=dtype, feature=feature), 2048))
        mp.setitem(port_factory.MODEL_REGISTRY, "resnet50",
                   lambda dtype, feature="both", **kw: (
                       ResNet50ReID(stage_sizes=STAGES, dtype=dtype, feature=feature), 2048))
        mp.setattr(jax_native_loader, "native_loader_available", lambda: False)
        mp.setattr(port_native_loader, "native_loader_available", lambda: False)
        mp.chdir(trees["root"])
        for name, (port_cli, jax_cli, args) in argv.items():
            for package, cli, validate_mod, extra in (
                    ("port", port_cli, port_validate, ["--device", "cpu"]),
                    ("jax", jax_cli, jax_validate, [])):
                log = []
                mp.setattr(validate_mod.Validator, "rank", _recording(ranked[package], log))
                out[package, name] = (cli.main(cli.build_argparser().parse_args(args + extra)),
                                      log)
    return out


def _assert_rankings_equal(log_p, log_j, n):
    assert len(log_p) == len(log_j) == n
    for i, ((d_p, cmc_p, map_p), (d_j, cmc_j, map_j)) in enumerate(zip(log_p, log_j)):
        assert d_p.shape == d_j.shape, i
        np.testing.assert_allclose(d_p, d_j, rtol=0, atol=2e-5, err_msg=str(i))
        np.testing.assert_array_equal(cmc_p, cmc_j, err_msg=str(i))
        assert abs(map_p - map_j) <= 1e-6, i


def test_evaluate_msmt17_turbulence_gallery_matches_jax(runs, trees):
    (res_p, log_p), (res_j, log_j) = runs["port", "evaluate_msmt17"], runs["jax", "evaluate_msmt17"]
    _assert_rankings_equal(log_p, log_j, 1)
    assert list(res_p) == list(res_j) == ["MSMT17"]
    np.testing.assert_array_equal(res_p["MSMT17"][0], log_p[0][1])
    assert log_p[0][0].shape == (4, 8)


def test_evaluate_prcc_and_briar_match_jax(runs):
    (res_p, log_p), (res_j, log_j) = (runs["port", "evaluate_prcc_briar"],
                                      runs["jax", "evaluate_prcc_briar"])
    # PRCC: 3 query sets x 10 gallery splits (the port extracts each split
    # once: its rankings come in the same order), then BRIAR
    _assert_rankings_equal(log_p, log_j, 31)
    assert list(res_p) == list(res_j) == ["PRCC:q0", "PRCC:q1", "PRCC:q2", "BRIAR"]
    for key in ("PRCC:q0", "PRCC:q1", "PRCC:q2"):
        assert res_p[key][0] == res_j[key][0]
        assert abs(res_p[key][1] - res_j[key][1]) <= 1e-6
    assert [d.shape for d, _, _ in log_p[:30:10]] == [(4, 4), (4, 4), (8, 4)]
    cmc, mAP = res_p["BRIAR"]
    assert 0.0 < mAP <= 1.0  # the standard protocol: a real mAP, not BRIAR's 0
    np.testing.assert_array_equal(cmc, log_p[30][1])


@pytest.mark.parametrize("cli", ["ensemble_briar", "fusion_briar"])
def test_fusion_clis_on_briar_manifests_match_jax(runs, cli):
    (res_p, log_p), (res_j, log_j) = runs["port", cli], runs["jax", cli]
    assert list(res_p) == list(res_j)
    _assert_rankings_equal(log_p, log_j, len(res_p))
    for tag, (_, cmc, mAP) in zip(res_p, log_p):
        assert res_p[tag]["rank1"] == cmc[0] and res_p[tag]["mAP"] == mAP
        assert mAP > 0.0


def test_search_msmt17_matches_jax(runs):
    (sims_p, ids_p, pids_p), _ = runs["port", "search_msmt17"]
    (sims_j, ids_j, pids_j), _ = runs["jax", "search_msmt17"]
    assert sims_p.shape == sims_j.shape == (4, 5) and np.isfinite(sims_p).all()
    np.testing.assert_array_equal(pids_p[:, 0], pids_j[:, 0])
    np.testing.assert_allclose(sims_p, sims_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("argv, match", [
    (["--targets", "BRIAR", "--train_file_path", "x"], "given together"),
    (["--targets", "Synthetic", "--train_file_path", "x", "--queries_file_path", "y",
      "--gallery_file_path", "z"], "BRIAR target only"),
    (["--targets", "BRIAR"], "requires"),
    (["--targets", "PRCC", "--multiple_output"], "not supported on multi-split"),
])
def test_evaluate_refusals(trees, argv, match, pil_only):
    extra = ["--data_root", trees["data"], "--img_height", str(IMG[0]), "--img_width",
             str(IMG[1]), "--batch_size", "16", "--compute_dtype", "float32"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_factory.MODEL_REGISTRY, "resnet50",
                   lambda dtype, feature="both", **kw: (
                       ResNet50ReID(stage_sizes=STAGES, dtype=dtype, feature=feature), 2048))
        with pytest.raises(SystemExit, match=match):
            port_evaluate.main(port_evaluate.build_argparser().parse_args(
                argv + extra + ["--device", "cpu"]))


def test_sie_camera_check_reads_every_split_of_a_multi_split_target(trees):
    from daliid_tpu_torch.cli.common import check_camera_ids

    prcc = port_registry.load_dataset("PRCC", root=trees["data"])
    check_camera_ids(4, (prcc["query"], prcc["gallery"]), "PRCC")
    with pytest.raises(SystemExit, match="camids run up to 3"):
        check_camera_ids(3, (prcc["query"], prcc["gallery"]), "PRCC")


# ---------------------------------------------------------------- train
def test_train_msmt17_pairs_pid_prefixed_copies_and_prints_balanced_accuracy(
        trees, weights, capsys, tmp_path):
    from daliid_tpu_torch.cli import train

    args = train.build_argparser().parse_args([
        "--dataset", "MSMT17", "--data_root", trees["data"], "--turbulence_dir_path",
        trees["turbulence"], "--kind_of_transform", "1", "--model_path", weights[0],
        "--img_height", str(IMG[0]), "--img_width", str(IMG[1]), "--P", "2", "--K", "2",
        "--epochs", "1", "--eval_freq", "1", "--compute_dtype", "float32",
        "--extractor_batch", "16", "--skip_initial_eval", "--device", "cpu",
        "--path_to_save_models", str(tmp_path / "ck"),
        "--path_to_save_metrics", str(tmp_path / "met")])
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_factory.MODEL_REGISTRY, "resnet50",
                   lambda dtype, feature="both", **kw: (
                       ResNet50ReID(stage_sizes=STAGES, dtype=dtype, feature=feature), 2048))
        mp.setattr(port_native_loader, "native_loader_available", lambda: False)
        calls = []
        original = port_validate.msmt17_balanced_accuracy

        def record(*a, **kw):
            calls.append(original(*a, **kw))
            return calls[-1]

        mp.setattr(train, "msmt17_balanced_accuracy", record)
        best_r1, best_iter = train.main(args)
    out = capsys.readouterr().out
    assert best_iter == 1 and len(calls) == 1 and 0.0 <= calls[0] <= 1.0
    assert f"Balanced Accuracy on Validation Set: {calls[0]:.3%}" in out
    assert (tmp_path / "ck" / "model_online_resnet50_v0.pt").exists()


# ---------------------------------------------------------------- multi-split targets
_MULTI_SPLIT = {
    "evaluate-ensemble": (port_ensemble, ["--dataset", "PRCC"]),
    "evaluate-fusion": (port_fusion, ["--dataset", "PRCC"]),
    "search": (port_search, ["--dataset", "PRCC"]),
    "train": (None, ["--dataset", "PRCC", "--epochs", "1", "--skip_initial_eval",
                     "--eval_freq", "1"]),
}


@pytest.mark.parametrize("command", sorted(_MULTI_SPLIT))
def test_multi_split_target_is_refused_by_name(trees, tmp_path, command):
    """PRCC's query sets and gallery splits are lists, which only evaluate
    ranks (split by split): the other commands refuse the target by name
    before any extraction, train before its first epoch when a validation
    would rank it (here the epoch-1 validation of a run that skips the
    initial one)."""
    from daliid_tpu_torch.cli import train

    cli, argv = _MULTI_SPLIT[command]
    cli = cli or train
    argv = argv + ["--data_root", trees["data"], "--device", "cpu"]
    if cli is train:
        argv += ["--path_to_save_models", str(tmp_path / "ck"),
                 "--path_to_save_metrics", str(tmp_path / "met")]
    with pytest.raises(SystemExit, match="PRCC is a multi-split protocol"):
        cli.main(cli.build_argparser().parse_args(argv))
    assert not (tmp_path / "ck").exists()  # refused before training


def test_jax_evaluate_ensemble_fails_on_a_multi_split_target(trees, monkeypatch):
    """Why the port refuses: the JAX evaluate-ensemble hands PRCC's list of
    query sets to its extractor, which reads each table as a path."""
    monkeypatch.setitem(jax_factory.MODEL_REGISTRY, "resnet50",
                        lambda dtype=jnp.float32, feature="both", **kw: (
                            FlaxResNet(stage_sizes=STAGES, dtype=dtype, feature=feature), 2048))
    monkeypatch.setattr(jax_native_loader, "native_loader_available", lambda: False)
    args = jax_ensemble.build_argparser().parse_args([
        "--dataset", "PRCC", "--data_root", trees["data"], "--img_height", str(IMG[0]),
        "--img_width", str(IMG[1]), "--batch_size", "16", "--compute_dtype", "float32"])
    with pytest.raises(FileNotFoundError, match="ReidTable"):
        jax_ensemble.main(args)
