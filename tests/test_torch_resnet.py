"""ResNet-50 ReID in the PyTorch port against the flax model (CPU, f32).

A flax ``ResNet50ReID(stage_sizes=(1, 1, 1, 1))`` initialized with
``jax.random.key(12)``, its BN scales, biases and running statistics then
drawn from a numpy seed so the BN mapping is exercised, is carried into the
port by ``variables_from_jax`` and by the JAX package's ``save_variables``
``.npz``. Both packages normalize and embed one uint8 batch in eval mode.

Tolerance: max |port - flax| <= 1e-4 * max |flax embedding|. Measured on
the CPU: at most 8.8e-7 of the embedding's largest entry, over gap, gmp and
both at 64x32 and 37x23 (float32 summation order in the convolutions).
The odd size also pins the padding question: flax's ``'SAME'`` on the 1x1
stride-2 projection equals torch ``padding=0``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from daliid_tpu.augment.preprocess import normalize_images as jax_normalize
from daliid_tpu.models.resnet import ResNet50ReID as FlaxResNet
from daliid_tpu.train.checkpoint import save_variables
from daliid_tpu_torch.augment.preprocess import normalize_images
from daliid_tpu_torch.models.resnet import ResNet50ReID
from daliid_tpu_torch.models.torch_port import load_state, read_jax_npz, variables_from_jax

STAGES = (1, 1, 1, 1)
REL_TOL = 1e-4


# BN leaves drawn anew (the convolutions are bias-free, so every "bias" is a BN's)
_BN_RANGES = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.1, 0.1), "var": (0.5, 2.0)}


def _flax_variables(feature, size):
    module = FlaxResNet(stage_sizes=STAGES, feature=feature)
    variables = module.init(jax.random.key(12), jnp.zeros((1, *size, 3)), train=False)
    rng = np.random.default_rng(3)

    def walk(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf)
            elif name in _BN_RANGES:
                out[name] = rng.uniform(*_BN_RANGES[name], leaf.shape).astype(np.float32)
            else:
                out[name] = np.asarray(leaf)
        return out

    return module, walk(variables)


def _images(size, n=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *size, 3), dtype=np.uint8)


def _port_embed(state_dict, feature, images):
    model = ResNet50ReID(stage_sizes=STAGES, feature=feature).eval()
    model.load_state_dict(state_dict, strict=True)
    with torch.inference_mode():
        return model(normalize_images(torch.from_numpy(images))).numpy()


def _flax_embed(module, variables, images):
    x = jax_normalize(jnp.asarray(images))
    return np.asarray(module.apply(variables, x, train=False))


@pytest.mark.parametrize("size", [(64, 32), (37, 23)])
@pytest.mark.parametrize("feature", ["gap", "gmp", "both"])
def test_variables_from_jax_matches_flax(feature, size):
    module, variables = _flax_variables(feature, size)
    images = _images(size)
    want = _flax_embed(module, variables, images)
    got = _port_embed(variables_from_jax("resnet50", variables), feature, images)
    assert got.shape == want.shape == (3, 2048) and got.dtype == np.float32
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= REL_TOL, err


def test_jax_npz_loads_into_the_port(tmp_path):
    """``save_variables``'s keystr ``.npz`` → the same state as the tree,
    and so the same embeddings."""
    size = (64, 32)
    module, variables = _flax_variables("both", size)
    path = str(tmp_path / "weights.npz")
    save_variables(path, variables)
    assert "['params']['layer1_0']['conv1']['kernel']" in np.load(path).files
    tree = read_jax_npz(path)
    direct, loaded = variables_from_jax("resnet50", variables), load_state("resnet50", path)
    assert direct.keys() == loaded.keys()
    for key in direct:
        assert torch.equal(direct[key], loaded[key]), key
    assert set(tree) == {"params", "batch_stats"}
    images = _images(size, seed=1)
    want = _flax_embed(module, variables, images)
    got = _port_embed(loaded, "both", images)
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


def test_same_padding_of_the_strided_1x1_projection_is_no_padding():
    """flax ``nn.Conv`` (default ``'SAME'``) with a 1x1 kernel at stride 2
    on odd and even sizes equals torch ``conv2d(padding=0)``."""
    rng = np.random.default_rng(4)
    for h, w in [(37, 23), (10, 7), (8, 8)]:
        x = rng.normal(size=(2, h, w, 5)).astype(np.float32)
        conv = nn.Conv(6, (1, 1), strides=(2, 2), use_bias=False)
        params = conv.init(jax.random.key(0), jnp.asarray(x))
        want = np.asarray(conv.apply(params, jnp.asarray(x)))
        kernel = np.asarray(params["params"]["kernel"]).transpose(3, 2, 0, 1)
        got = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(kernel.copy()),
                       stride=2, padding=0).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_extractor_pads_the_tail_batch_and_trims_it(tmp_path):
    """Six images through batches of 4 (a padded tail of 2) give the
    embeddings of one forward over all six, within float32 summation order
    (rtol 1e-5), in the input order."""
    from PIL import Image

    from daliid_tpu_torch.eval.features import FeatureExtractor
    from daliid_tpu_torch.models.factory import ModelBundle, init_weights

    images = _images((40, 20), n=6, seed=2)
    paths = []
    for i, im in enumerate(images):
        paths.append(str(tmp_path / f"{i}.png"))  # lossless, so the decode is exact
        Image.fromarray(im).save(paths[-1])
    model = ResNet50ReID(stage_sizes=STAGES).eval()
    init_weights(model, torch.Generator().manual_seed(0))
    bundle = ModelBundle(module=model, feature_dim=2048, name="resnet50")
    got = FeatureExtractor(bundle, img_size=(40, 20), batch_size=4, device="cpu").extract(paths)
    with torch.inference_mode():
        want = model(normalize_images(torch.from_numpy(images))).numpy()
    assert got.shape == (6, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
