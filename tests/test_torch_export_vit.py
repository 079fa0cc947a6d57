"""``export``'s conversions for the ViT family in the PyTorch port against the
JAX package (CPU), and the key tables' round trip for every factory name.

- ``vit`` (torchvision's ``vit_b_16`` scheme with its zero ImageNet head),
  ``vit_small`` (no qkv bias), ``transreid`` (SIE) and ``transreid_jpm``
  under softmax and under a margin head: the port's ``state_to_torch`` of
  ``variables_from_jax`` gives the keys and bit-equal arrays of the JAX
  package's ``variables_to_torch``, and ``variables_to_jax`` of
  ``state_from_torch`` gives the JAX package's ``variables_from_torch``
  tree, bit for bit. Small ViTs (embed 32, 2 heads, depth 2, 8x8 patches on
  32x16 images: stride 8, or 6 for the overlapping TransReID trunks), built
  on both sides with the same variables drawn from numpy;
- both packages' ``export`` CLIs end to end for the JPM, rebound as
  ``transreid_jpm`` in both registries: the same files both ways;
- ``variables_from_jax(variables_to_jax(sd))`` equals ``sd`` bit for bit
  for all 18 factory names at full width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daliid_tpu.models as jax_models
from daliid_tpu.cli import export as jax_export
from daliid_tpu.models import factory as jax_factory
from daliid_tpu.models import torch_port as jax_port
from daliid_tpu.models.transreid_jpm import TransReIDJPM as FlaxJPM
from daliid_tpu.models.vit import ViTReID as FlaxViT
from daliid_tpu.train import checkpoint as jax_checkpoint
from daliid_tpu_torch.cli import export as port_export
from daliid_tpu_torch.models import factory as port_factory
from daliid_tpu_torch.models.torch_port import (
    state_from_torch,
    state_to_torch,
    variables_from_jax,
    variables_to_jax,
)
from daliid_tpu_torch.models.transreid_jpm import TransReIDJPM
from daliid_tpu_torch.models.vit import ViTReID

IMG = (32, 16)
TINY = dict(embed_dim=32, depth=2, num_heads=2, drop_path_rate=0.0)
# name → (module keywords of both sides, patch stride)
VITS = {"vit": ({}, 8), "vit_small": ({"qkv_bias": False, "qk_scale": 32 ** -0.5}, 8),
        "transreid": ({"sie_cameras": 4}, 6)}
JPM_HEADS = {"softmax": {"num_classes": 5},
             "arcface": {"num_classes": 5, "id_loss_type": "arcface"}}
_RANGES = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.1, 0.1), "var": (0.5, 2.0)}


def _drawn(module, seed=3):
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.key(0), jnp.zeros((1, *IMG, 3)), camera_ids=jnp.zeros((1,), jnp.int32),
        train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in _RANGES:
            return rng.uniform(*_RANGES[name], s.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, s.shape).astype(np.float32)

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(leaf, shapes))


def _pair(name, kw):
    """(flax module, port module) of one configuration."""
    if name == "transreid_jpm":
        common = dict(img_size=IMG, patch_size=8, patch_stride=6, **TINY, **kw)
        return FlaxJPM(**common), TransReIDJPM(**common)
    extra, stride = VITS[name]
    common = dict(img_size=IMG, patch_size=8, patch_stride=stride, **TINY, **extra)
    return FlaxViT(**common), ViTReID(**common)


CASES = [(name, {}) for name in VITS] + [("transreid_jpm", kw) for kw in JPM_HEADS.values()]
IDS = list(VITS) + [f"transreid_jpm-{h}" for h in JPM_HEADS]


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_state_to_torch_writes_the_jax_reference_scheme(name, kw):
    flax_m, port_m = _pair(name, kw)
    variables = _drawn(flax_m)
    want = jax_port.variables_to_torch(name, variables, module=flax_m)
    got = state_to_torch(name, variables_from_jax(name, variables), port_m)
    assert set(got) == set(want)
    if name == "vit":
        assert "heads.head.weight" in got and "class_token" in got and "last_bn.weight" in got
        assert not got["heads.head.weight"].any() and got["heads.head.weight"].shape == (1000, 32)
    for key, w in want.items():
        assert got[key].dtype == torch.float32 and np.array_equal(got[key].numpy(), w), key


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_variables_to_jax_reads_the_reference_scheme_as_jax_does(name, kw):
    flax_m, port_m = _pair(name, kw)
    variables = _drawn(flax_m)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in jax_port.variables_to_torch(name, variables, module=flax_m).items()}
    want = jax_port.variables_from_torch(name, sd, module=flax_m)
    got = variables_to_jax(name, state_from_torch(name, sd, port_m))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert jax.tree.all(jax.tree.map(np.array_equal, got, want))
    port_m.load_state_dict(variables_from_jax(name, got), strict=True)


@pytest.fixture
def tiny_jpm(monkeypatch):
    """The JPM of ``_pair`` as ``transreid_jpm`` in both registries, for the
    CLIs."""
    def flax_factory(dtype=jnp.float32, img_size=IMG, num_classes=0, **kw):
        return _pair("transreid_jpm", {"num_classes": num_classes})[0], 5 * 32

    def port_factory_fn(dtype=torch.float32, img_size=IMG, num_classes=0, **kw):
        return _pair("transreid_jpm", {"num_classes": num_classes})[1], 5 * 32

    def jax_get_model(name, rng, img_size=IMG, dtype=jnp.float32, **kw):
        module, dim = jax_factory.MODEL_REGISTRY[name](dtype=dtype, img_size=img_size, **kw)
        return jax_factory.ModelBundle(module=module, variables=_drawn(module),
                                       feature_dim=dim, name=name)

    monkeypatch.setitem(jax_factory.MODEL_REGISTRY, "transreid_jpm", flax_factory)
    monkeypatch.setitem(port_factory.MODEL_REGISTRY, "transreid_jpm", port_factory_fn)
    monkeypatch.setattr(jax_models, "get_model", jax_get_model)


@pytest.mark.parametrize("direction", ["to_npz", "to_torch"])
def test_export_cli_of_the_jpm_matches_the_jax_cli(tiny_jpm, tmp_path, direction):
    flax_m = _pair("transreid_jpm", JPM_HEADS["softmax"])[0]
    variables = _drawn(flax_m, seed=7)
    if direction == "to_npz":
        src, ext = tmp_path / "ref.pth", ".npz"
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                    jax_port.variables_to_torch("transreid_jpm", variables,
                                                module=flax_m).items()}, src)
    else:
        src, ext = tmp_path / "w.npz", ".pth"
        jax_checkpoint.save_variables(str(src), variables)
    argv = ["--model_name", "transreid_jpm", "--input", str(src), "--img_height", str(IMG[0]),
            "--img_width", str(IMG[1]), "--num_classes", "5"]
    jax_export.main(jax_export.build_argparser().parse_args(
        argv + ["--output", str(tmp_path / f"jax{ext}")]))
    port_export.main(port_export.build_argparser().parse_args(
        argv + ["--output", str(tmp_path / f"port{ext}"), "--device", "cpu"]))
    if ext == ".npz":
        with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
            assert set(got.files) == set(want.files)
            assert all(np.array_equal(got[k], want[k]) for k in want.files)
    else:
        want = torch.load(tmp_path / "jax.pth", weights_only=True)
        got = torch.load(tmp_path / "port.pth", weights_only=True)
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("name", sorted(port_factory.MODEL_REGISTRY))
def test_variables_from_jax_inverts_variables_to_jax(name):
    size = (128, 128) if name == "inceptionV3" else (64, 32)
    kw = {"num_classes": 5} if name in ("densenet121", "transreid_jpm") else {}
    gen = torch.Generator().manual_seed(5)
    module = port_factory.get_model(name, gen, img_size=size, **kw).module
    with torch.no_grad():  # every BN statistic away from its init
        for key, t in module.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                t.uniform_(0.5, 1.5, generator=gen)
    sd = {k: v for k, v in module.state_dict().items() if not k.endswith("num_batches_tracked")}
    back = variables_from_jax(name, variables_to_jax(name, sd))
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
