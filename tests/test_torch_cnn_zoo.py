"""OSNet, DenseNet-121, EfficientNet-B0 and Inception-V3 of the port against
their flax modules (CPU).

Each family is built on both sides; the flax variables (every kernel,
BN scale, bias and running statistic and every gate bias drawn from a
numpy seed) are carried into the port by ``variables_from_jax``, never
initialized apart. Sizes: OSNet and EfficientNet at full width on 64x32
images, DenseNet with ``block_sizes=(1, 1, 1, 1)`` and ``growth=8`` on
64x32, Inception-V3 at full width on 128x128 (its stem collapses below
about 75 pixels); batches of 8.

Tolerances, each with its reason:

- f32 embeddings in eval mode: max |port - flax| <= 1e-4 of the largest
  entry (float32 summation order in the convolutions);
- train mode (batch statistics in every BN): the outputs, and each
  updated running statistic, within ``TRAIN_TOL`` of the largest entry,
  per family. A deep trunk normalized by the statistics of a batch of 8
  small maps amplifies float32 rounding: on these inputs the flax
  forward itself differs from a float64 evaluation of the same network by
  4e-5 (EfficientNet-B0), 5e-4 (OSNet) and 5e-3 (Inception-V3), the port
  by 3 to 10 times less; each bound is about 4 times the port-flax
  difference measured on the CPU;
- a reference-scheme checkpoint carried through ``state_from_torch``:
  every tensor equal to ``variables_from_jax``'s, so its forward is the
  eval case's.
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daliid_tpu.augment.preprocess import normalize_images as jax_normalize
from daliid_tpu.models import densenet as flax_densenet
from daliid_tpu.models import factory as jax_factory
from daliid_tpu.models import torch_port as jax_torch_port
from daliid_tpu.models.efficientnet import EfficientNetB0ReID as FlaxEfficientNet
from daliid_tpu.models.inception import InceptionV3ReID as FlaxInception
from daliid_tpu.models.osnet import OSNetReID as FlaxOSNet
from daliid_tpu_torch.augment.preprocess import normalize_images
from daliid_tpu_torch.models import factory as port_factory
from daliid_tpu_torch.models.densenet import DenseNet121ReID
from daliid_tpu_torch.models.efficientnet import EfficientNetB0ReID
from daliid_tpu_torch.models.inception import InceptionV3ReID
from daliid_tpu_torch.models.osnet import OSNetReID
from daliid_tpu_torch.models.torch_port import state_from_torch, variables_from_jax

REL_TOL = 1e-4
TRAIN_TOL = {"densenet121": 1e-4, "efficientnetB0": 2e-4, "osnet": 2e-3, "inceptionV3": 2e-2}
TINY_DENSE = {"block_sizes": (1, 1, 1, 1), "growth": 8}
# name → (flax module, port module, input size, an upstream head the
# reference wrapper keeps unused, as one of its keys)
FAMILIES = {
    "osnet": (lambda **kw: FlaxOSNet(), lambda **kw: OSNetReID(), (64, 32), "fc.weight"),
    "densenet121": (lambda **kw: flax_densenet.DenseNet121ReID(**TINY_DENSE, **kw),
                    lambda **kw: DenseNet121ReID(**TINY_DENSE, **kw), (64, 32),
                    "model_base.classifier.weight"),
    "efficientnetB0": (lambda **kw: FlaxEfficientNet(), lambda **kw: EfficientNetB0ReID(),
                       (64, 32), "classifier.1.weight"),
    "inceptionV3": (lambda **kw: FlaxInception(), lambda **kw: InceptionV3ReID(), (128, 128),
                    "AuxLogits.conv0.conv.weight"),
}
_RANGES = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.1, 0.1), "var": (0.5, 2.0)}


def _variables(module, size, seed=3):
    """The module's variables drawn from a numpy seed at the shapes of its
    flax init (``eval_shape``: an eager init of these trunks takes half a
    minute on the CPU): every scale, bias and BN statistic uniform in
    ``_RANGES``, every kernel ~ N(0, 1/fan_in), flax's LeCun normal. The
    init runs in train mode, where DenseNet creates its classifier."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.key(0), jnp.zeros((1, *size, 3)), train=True))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in _RANGES:
            return rng.uniform(*_RANGES[name], s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _images(size, n=8, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *size, 3), dtype=np.uint8)


def _rel_err(got: torch.Tensor, want) -> float:
    g, w = got.detach().numpy(), np.asarray(want)
    assert g.shape == w.shape and g.dtype == np.float32
    return float(np.abs(g - w).max() / np.abs(w).max())


@pytest.fixture(scope="module")
def flax_models():
    """name → (flax module, randomized variables), built once; DenseNet
    with a 5-way classifier head."""
    out = {}
    for name, (flax_fn, _, size, _) in FAMILIES.items():
        module = flax_fn(**({"num_classes": 5} if name == "densenet121" else {}))
        out[name] = (module, _variables(module, size))
    return out


def _port(name, variables, **kw):
    model = FAMILIES[name][1](**kw)
    model.load_state_dict(variables_from_jax(name, variables), strict=True)
    return model


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_eval_forward_matches_flax(flax_models, name):
    module, variables = flax_models[name]
    kw = {"num_classes": 5} if name == "densenet121" else {}
    model = _port(name, variables, **kw).eval()
    images = _images(FAMILIES[name][2])
    want = module.apply(variables, jax_normalize(jnp.asarray(images)), train=False)
    with torch.inference_mode():
        got = model(normalize_images(torch.from_numpy(images)))
    assert _rel_err(got, want) <= REL_TOL


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_train_forward_and_running_stats_match_flax(flax_models, name):
    """One train-mode forward: batch statistics in every BN, the running
    statistics updated (DenseNet also returns its logits)."""
    module, variables = flax_models[name]
    kw = {"num_classes": 5} if name == "densenet121" else {}
    model = _port(name, variables, **kw).train()
    images = _images(FAMILIES[name][2], seed=1)
    want, updates = module.apply(variables, jax_normalize(jnp.asarray(images)), train=True,
                                 mutable=["batch_stats"])
    with torch.no_grad():
        got = model(normalize_images(torch.from_numpy(images)))
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want) == (2 if name == "densenet121" else 1)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= TRAIN_TOL[name]
    new = variables_from_jax(name, {"params": variables["params"],
                                    "batch_stats": updates["batch_stats"]})
    old = variables_from_jax(name, variables)
    state = model.state_dict()
    running = [k for k in new if "running" in k]
    assert len(running) > 10
    assert max(_rel_err(state[k], new[k].numpy()) for k in running) <= TRAIN_TOL[name]
    assert min(float((new[k] - old[k]).abs().max()) for k in running) > 1e-4  # all updated


def _reference_export(name, variables):
    """The JAX package's reference-scheme export (the tiny DenseNet's
    through its own block sizes), plus one unused upstream head."""
    if name == "densenet121":
        exported = jax_torch_port.densenet121_reid_to_torch_keys(
            variables, block_sizes=TINY_DENSE["block_sizes"])
    else:
        exported = jax_torch_port.variables_to_torch(name, variables)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in exported.items()}
    sd[FAMILIES[name][3]] = torch.zeros(3, 4)
    return sd


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_state_from_torch_reads_the_reference_scheme(flax_models, name):
    """A checkpoint in the reference wrapper's key scheme loads strictly:
    the unused upstream head dropped, every tensor as ``variables_from_jax``
    carries it, so the forward equals the JAX one."""
    module, variables = flax_models[name]
    kw = {"num_classes": 5} if name == "densenet121" else {}
    model = FAMILIES[name][1](**kw).eval()
    sd = {"module." + k: v for k, v in _reference_export(name, variables).items()}
    loaded = state_from_torch(name, sd, model)
    direct = variables_from_jax(name, variables)
    assert loaded.keys() == direct.keys() == model.state_dict().keys()
    for k in direct:
        assert torch.equal(loaded[k], direct[k]), k
    model.load_state_dict(loaded, strict=True)
    images = _images(FAMILIES[name][2], seed=2)
    want = module.apply(variables, jax_normalize(jnp.asarray(images)), train=False)
    with torch.inference_mode():
        got = model(normalize_images(torch.from_numpy(images)))
    assert _rel_err(got, want) <= REL_TOL


def test_densenet_classifier_is_dropped_for_a_model_without_one(flax_models):
    """Evaluation builds ``densenet121`` with ``num_classes=0``: a trained
    checkpoint's classifier is not read."""
    _, variables = flax_models["densenet121"]
    model = DenseNet121ReID(**TINY_DENSE).eval()
    loaded = state_from_torch("densenet121", _reference_export("densenet121", variables), model)
    assert not any(k.startswith("classification") for k in loaded)
    model.load_state_dict(loaded, strict=True)


def test_osnet_shares_one_gate_across_its_four_streams():
    block = OSNetReID().conv2[0]
    gates = [m for m in block.modules() if type(m).__name__ == "ChannelGate"]
    assert len(gates) == 1
    assert sorted(k for k in block.state_dict() if k.startswith("gate.")) == [
        "gate.fc1.bias", "gate.fc1.weight", "gate.fc2.bias", "gate.fc2.weight"]


def _jax_factory_names():
    """The names ``daliid_tpu/models/factory.py`` registers itself (other
    test modules register more into the live JAX registry)."""
    names = set(re.findall(r'@register_model\("(\w+)"\)', inspect.getsource(jax_factory)))
    assert names <= set(jax_factory.MODEL_REGISTRY)
    return names


def test_check_model_name_accepts_all_eighteen():
    """The JAX package's 18 names, plus the named set of models that exist
    only in the port."""
    names = _jax_factory_names()
    assert len(names) == 18 and not names & port_factory.PORT_ONLY_MODELS
    assert port_factory.PORT_ONLY_MODELS == {"swin_base"}
    assert set(port_factory.MODEL_REGISTRY) == names | port_factory.PORT_ONLY_MODELS
    for name in names | port_factory.PORT_ONLY_MODELS:
        port_factory.check_model_name(name)
    with pytest.raises(KeyError, match="not yet ported"):
        port_factory.check_model_name("vit_base")
    dims = {"osnet": 512, "densenet121": 2048, "efficientnetB0": 1280, "inceptionV3": 2048}
    for name, dim in dims.items():
        assert port_factory.MODEL_REGISTRY[name](dtype=torch.float32)[1] == dim
    dense = port_factory.get_model("densenet121", num_classes=7).module
    assert dense.classification.weight.shape == (7, 2048) and not dense.training


def test_build_ensembles_pairs():
    """Three (online, momentum) pairs: resnet50, osnet, densenet121 by
    default; online equal to momentum; each backbone's weights its own,
    the same name at another position included; the same seed rebuilds the
    same weights."""
    pairs = port_factory.build_ensembles(torch.Generator().manual_seed(4))
    assert [p[0].name for p in pairs] == ["resnet50", "osnet", "densenet121"]
    assert [p[0].feature_dim for p in pairs] == [2048, 512, 2048]
    for online, momentum in pairs:
        a, b = online.module.state_dict(), momentum.module.state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        assert online.module is not momentum.module
    stems = [pairs[0][0].module.conv1.weight, pairs[2][0].module.model_base.conv0.weight]
    assert stems[0].shape == stems[1].shape and not torch.equal(*stems)
    twice = port_factory.build_ensembles(torch.Generator().manual_seed(4),
                                         names=("osnet", "osnet"))
    w = [p[0].module.conv1.conv.weight for p in twice]
    assert not torch.equal(*w)
    assert torch.equal(w[1], pairs[1][0].module.conv1.conv.weight)
