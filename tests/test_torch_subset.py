"""``eval/subset.py::mine_subset`` of the PyTorch port against the JAX
package's, on the CPU.

Both packages embed a synthetic train set (6 identities x 3 images at
32x16, decoded with PIL on both sides) with the same weights: ``deit_small``
at full width (its flax variables drawn from a numpy seed at the shapes of
the flax init and carried across by ``variables_from_jax``) and, as a
second extractor, a ResNet of one block a stage. The order of the train
rows must be the JAX package's wherever adjacent similarities differ by
more than ``GAP`` (f32 embeddings of two frameworks differ by about 1e-6;
rows closer than that may swap); the selected row comes first.

A multi-head extractor's tuple of head embeddings: the JAX function stacks
it into a (heads, N, D) array and fails in its product; the port refuses it
with a ``ValueError`` that names the model (the choice is pinned here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daliid_tpu.data import native_loader as jax_native_loader
from daliid_tpu.data.registry import ReidTable as JaxTable
from daliid_tpu.eval.features import FeatureExtractor as JaxExtractor
from daliid_tpu.eval.subset import mine_subset as jax_mine_subset
from daliid_tpu.models import factory as jax_factory
from daliid_tpu.models.resnet import MultiPartResNet50ReID as FlaxMultiPart
from daliid_tpu.models.resnet import ResNet50ReID as FlaxResNet
from daliid_tpu_torch.data import make_synthetic_dataset
from daliid_tpu_torch.data import native_loader as port_native_loader
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.eval.subset import mine_subset
from daliid_tpu_torch.models import factory as port_factory
from daliid_tpu_torch.models.resnet import MultiPartResNet50ReID, ResNet50ReID
from daliid_tpu_torch.models.torch_port import variables_from_jax

IMG = (32, 16)
STAGES = (1, 1, 1, 1)
GAP = 1e-5
_RANGES = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.1, 0.1), "var": (0.5, 2.0)}


def _drawn(module, seed):
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.key(0), jnp.zeros((1, *IMG, 3)), train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in _RANGES:
            return rng.uniform(*_RANGES[name], s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]) or 1)).astype(
            np.float32)

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(leaf, shapes))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The train tables of both packages and (JAX, port) extractor pairs:
    'deit_small', 'resnet' and the multi-head 'multipart'."""
    root = tmp_path_factory.mktemp("torch_subset")
    splits, _ = make_synthetic_dataset(str(root / "Synthetic"), num_ids=6, imgs_per_id_train=3,
                                       imgs_per_id_test=1, height=IMG[0], width=IMG[1],
                                       with_turbulence=False)
    t = splits["train"]
    jax_table = JaxTable(paths=t.paths, pids=t.pids, camids=t.camids, kinds=t.kinds, name=t.name)
    deit = jax_factory.MODEL_REGISTRY["deit_small"](dtype=jnp.float32, img_size=IMG)[0]
    pairs = {}
    for key, flax, port, port_key, seed in (
            ("deit_small", deit, port_factory.get_model("deit_small", img_size=IMG).module,
             "deit_small", 3),
            ("resnet", FlaxResNet(stage_sizes=STAGES), ResNet50ReID(stage_sizes=STAGES),
             "resnet50", 4),
            ("multipart", FlaxMultiPart(stage_sizes=STAGES),
             MultiPartResNet50ReID(stage_sizes=STAGES), "multipart_resnet50", 5)):
        variables = _drawn(flax, seed)
        port.load_state_dict(variables_from_jax(port_key, variables), strict=True)
        jb = jax_factory.ModelBundle(module=flax, variables=variables, feature_dim=0, name=key)
        pb = port_factory.ModelBundle(module=port.eval(), feature_dim=0, name=port_key)
        pairs[key] = (JaxExtractor(jb, img_size=IMG, batch_size=8),
                      FeatureExtractor(pb, img_size=IMG, batch_size=8, device="cpu"))
    return jax_table, t, pairs


@pytest.fixture(autouse=True)
def pil_on_both_sides(monkeypatch):
    monkeypatch.setattr(jax_native_loader, "native_loader_available", lambda: False)
    monkeypatch.setattr(port_native_loader, "native_loader_available", lambda: False)


def _sims(extractors, table, row):
    """The mean cosine similarity of ``row`` to every row, in float64."""
    total = 0.0
    for ex in extractors:
        e = np.asarray(ex.extract(table), np.float64)
        e /= np.linalg.norm(e, axis=1, keepdims=True)
        total = total + e @ e[row]
    return total / len(extractors)


def _assert_same_order(got, want, sims):
    """``got`` lists ``want``'s rows in its order, up to swaps of rows whose
    similarities are within ``GAP``."""
    assert sorted(got) == sorted(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            assert abs(sims[g] - sims[w]) <= GAP, (i, g, w, sims[g], sims[w])


@pytest.mark.parametrize("names,split", [(("deit_small",), {"top_k": 5}),
                                         (("deit_small", "resnet"), {"perc_closest": 0.5})],
                         ids=["deit_small-top_k", "deit_small+resnet-perc_closest"])
def test_mine_subset_orders_the_rows_as_jax_does(world, names, split):
    jax_table, table, pairs = world
    row = 4
    want = jax_mine_subset(jax_table[np.arange(row, row + 1)], jax_table,
                           [pairs[n][0] for n in names], **split)
    got = mine_subset(table[np.arange(row, row + 1)], table, [pairs[n][1] for n in names],
                      **split)
    k = len(want[0])
    assert len(got[0]) == k and k == (5 if "top_k" in split else len(table) // 2)
    assert got[0][0] == row and want[0][0] == row
    sims = _sims([pairs[n][0] for n in names], jax_table, row)
    _assert_same_order(np.concatenate(got), np.concatenate(want), sims)


def test_mine_subset_takes_exactly_one_of_top_k_and_perc_closest(world):
    jax_table, table, pairs = world
    for kw in ({}, {"top_k": 2, "perc_closest": 0.5}):
        with pytest.raises(ValueError, match="exactly one"):
            jax_mine_subset(jax_table[np.arange(1)], jax_table, [pairs["resnet"][0]], **kw)
        with pytest.raises(ValueError, match="exactly one"):
            mine_subset(table[np.arange(1)], table, [pairs["resnet"][1]], **kw)


def test_a_multihead_extractor_fails_in_jax_and_is_refused_by_name(world):
    jax_table, table, pairs = world
    with pytest.raises((TypeError, ValueError)):
        jax_mine_subset(jax_table[np.arange(1)], jax_table, [pairs["multipart"][0]], top_k=3)
    with pytest.raises(ValueError, match="multipart_resnet50 returns a tuple"):
        mine_subset(table[np.arange(1)], table, [pairs["multipart"][1]], top_k=3)
