"""``export`` and the ``.npz`` weights of the PyTorch port against the JAX
package, on the CPU: the CNN families.

- For each family (resnet50, resnet50IBN, osnet, densenet121 with and
  without ``--num_classes``, inceptionV3, efficientnetB0, at
  ``--img_height 64 --img_width 32``; Inception-V3 at 128x128, since its
  stem collapses below about 75 pixels and the JAX package cannot build it
  smaller) the JAX package's ``export`` and the port's, on the same input,
  write the same keys with bit-equal arrays, in both directions (a
  reference torch pickle → ``.npz`` here, an ``.npz`` → a torch pickle in
  ``tests/test_torch_export_torch.py``). The JAX side's variables are
  drawn from a numpy seed at the shapes of the flax init (``eval_shape``:
  an eager init of these trunks takes half a minute on the CPU), in train
  mode, where DenseNet creates its classifier (the JAX factory's eval-mode
  init does not, a fault of the JAX package in ROADMAP Queue 3);
- ``save_variables`` writes the JAX package's file, and ``load_variables``
  refuses a missing key and a wrong shape in the JAX package's words;
- the multi-head ResNets: the JAX package's export to a torch pickle loses
  their heads (multi-part, multi-view) or fails (dual); the port's refusal
  is in ``tests/test_torch_export_torch.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daliid_tpu.models as jax_models
from daliid_tpu.cli import export as jax_export
from daliid_tpu.models import factory as jax_factory
from daliid_tpu.models.torch_port import variables_to_torch as jax_variables_to_torch
from daliid_tpu.train import checkpoint as jax_checkpoint
from daliid_tpu_torch.cli import export as port_export
from daliid_tpu_torch.train import checkpoint as port_checkpoint

IMG = (64, 32)
FAMILIES = [("resnet50", 0), ("resnet50IBN", 0), ("osnet", 0), ("densenet121", 0),
            ("densenet121", 5), ("inceptionV3", 0), ("efficientnetB0", 0)]
SIZES = {"inceptionV3": (128, 128)}
MULTIHEAD = ("dualresnet50", "multipart_resnet50", "multiview_resnet50")
_RANGES = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.1, 0.1), "var": (0.5, 2.0)}


def _drawn(module, size=IMG, seed=3):
    """Flax variables at the shapes of ``module``'s train-mode init, drawn
    from a numpy seed (scales, biases and statistics uniform in
    ``_RANGES``, kernels ~ N(0, 1/fan_in))."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.key(0), jnp.zeros((1, *size, 3)), train=True))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in _RANGES:
            return rng.uniform(*_RANGES[name], s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(leaf, shapes))


@pytest.fixture
def drawn_jax_models(monkeypatch):
    """The JAX export's ``get_model`` builds the registry's module with
    drawn variables (``_drawn``) instead of an eager init."""
    def get_model(name, rng, img_size=(256, 128), dtype=jnp.float32, **kw):
        module, dim = jax_factory.MODEL_REGISTRY[name](dtype=dtype, img_size=img_size, **kw)
        return jax_factory.ModelBundle(module=module, variables=_drawn(module, tuple(img_size)),
                                       feature_dim=dim, name=name)

    monkeypatch.setattr(jax_models, "get_model", get_model)
    return get_model


def _argv(name, src, dst, num_classes):
    size = SIZES.get(name, IMG)
    argv = ["--model_name", name, "--input", str(src), "--output", str(dst),
            "--img_height", str(size[0]), "--img_width", str(size[1])]
    return argv + (["--num_classes", str(num_classes)] if num_classes else [])


def _both(tmp_path, name, src, ext, num_classes):
    """Both packages' export of ``src`` → (JAX's output, the port's)."""
    jax_out, port_out = tmp_path / f"jax{ext}", tmp_path / f"port{ext}"
    jax_export.main(jax_export.build_argparser().parse_args(
        _argv(name, src, jax_out, num_classes)))
    port_export.main(port_export.build_argparser().parse_args(
        _argv(name, src, port_out, num_classes) + ["--device", "cpu"]))
    return jax_out, port_out


def _module(name, num_classes):
    kw = {"num_classes": num_classes} if num_classes else {}
    return jax_factory.MODEL_REGISTRY[name](dtype=jnp.float32, img_size=SIZES.get(name, IMG),
                                            **kw)[0]


@pytest.mark.parametrize("name,num_classes", FAMILIES)
def test_torch_to_npz_matches_the_jax_export(drawn_jax_models, tmp_path, name, num_classes):
    module = _module(name, num_classes)
    variables = _drawn(module, SIZES.get(name, IMG))
    src = tmp_path / "reference.pth"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                jax_variables_to_torch(name, variables, module=module).items()}, src)
    jax_out, port_out = _both(tmp_path, name, src, ".npz", num_classes)
    with np.load(jax_out) as want, np.load(port_out) as got:
        assert set(got.files) == set(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_save_variables_writes_the_jax_file(tmp_path):
    variables = _drawn(_module("osnet", 0))
    jax_checkpoint.save_variables(str(tmp_path / "jax.npz"), variables)
    port_checkpoint.save_variables(str(tmp_path / "port.npz"), variables)
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert got.files == want.files  # the same keys in the same order
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key])
    back = port_checkpoint.load_variables(str(tmp_path / "jax.npz"), variables)
    assert jax.tree.all(jax.tree.map(np.array_equal, back, variables))


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_load_variables_refuses_in_the_jax_words(tmp_path, fault):
    template = {"params": {"conv1": {"kernel": np.zeros((3, 3, 3, 8), np.float32)},
                           "bn1": {"scale": np.ones(8, np.float32)}},
                "batch_stats": {"bn1": {"mean": np.zeros(8, np.float32)}}}
    saved = jax.tree.map(np.copy, template)
    if fault == "missing":
        del saved["params"]["bn1"]
    else:
        saved["params"]["conv1"]["kernel"] = np.zeros((3, 3, 3, 4), np.float32)
    saved["params"]["extra"] = {"kernel": np.ones(2, np.float32)}  # ignored by both
    path = str(tmp_path / "w.npz")
    jax_checkpoint.save_variables(path, saved)
    error = KeyError if fault == "missing" else ValueError
    with pytest.raises(error) as want:
        jax_checkpoint.load_variables(path, template)
    with pytest.raises(error) as got:
        port_checkpoint.load_variables(path, template)
    assert str(got.value) == str(want.value)
    assert ("checkpoint missing ['params']['bn1']['scale']" if fault == "missing"
            else "shape mismatch for ['params']['conv1']['kernel']") in str(got.value)


@pytest.mark.parametrize("name", MULTIHEAD)
def test_jax_export_of_a_multihead_resnet_to_torch_loses_its_heads(drawn_jax_models, tmp_path,
                                                                  name):
    """The fault of the JAX package that the port's refusal answers: the
    reference ResNet-50 scheme has no keys for the heads."""
    from daliid_tpu_torch.models.torch_port import _HEADS_WITHOUT_TORCH_KEYS

    src, out = tmp_path / "w.npz", tmp_path / "w.pth"
    jax_checkpoint.save_variables(str(src), _drawn(_module(name, 0)))
    args = jax_export.build_argparser().parse_args(_argv(name, src, out, 0))
    if name == "dualresnet50":
        with pytest.raises(KeyError):  # it has no last_bn for the scheme to write
            jax_export.main(args)
        return
    jax_export.main(args)
    keys = torch.load(out, weights_only=True)
    heads = _HEADS_WITHOUT_TORCH_KEYS[name]
    assert not any(k.startswith(h + ".") for k in keys for h in heads)
