"""The ViT / TransReID backbone of the PyTorch port against the flax model,
on the CPU in f32.

A flax ``ViTReID`` at a small size (embed 64, 2 heads of 32, depth 2, 32x16
images, 8x8 patches) is initialized with a JAX key; its LayerNorm, bias and
BN-neck leaves are then drawn from a numpy seed so that every mapping is
exercised. ``variables_from_jax`` carries the weights into the port, and
both embed one numpy batch in eval mode and with train-mode BN (at
``drop_path_rate`` 0: JAX's drop-path key cannot be replayed in torch).
The cases cover overlapping patches, SIE with 3 cameras, ``qkv_bias=False``
with a custom ``qk_scale``, both GELUs and both attention routes (the JAX
side's Pallas kernel in interpret mode).

Tolerance: max |port - flax| <= 1e-4 * max |flax| (f32 summation order in
the matrix products and LayerNorm; measured at most 3.9e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daliid_tpu.models.torch_port import vit_reid_from_torch, vit_reid_to_torch_keys
from daliid_tpu.models.vit import ViTReID as FlaxViT
from daliid_tpu.models.vit import resize_pos_embed as jax_resize_pos_embed
from daliid_tpu_torch.models.torch_port import state_from_torch, variables_from_jax
from daliid_tpu_torch.models.vit import ViTReID, drop_path, resize_pos_embed

IMG = (32, 16)
SMALL = dict(img_size=IMG, patch_size=8, embed_dim=64, depth=2, num_heads=2,
             drop_path_rate=0.0)
REL_TOL = 1e-4

_RANGES = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.1, 0.1), "var": (0.5, 2.0)}


def randomize(tree, seed=3):
    """Redraw every scale, bias, mean and var leaf from a numpy seed."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else (rng.uniform(*_RANGES[k], np.shape(v)).astype(np.float32)
                      if k in _RANGES else np.asarray(v))
                for k, v in node.items()}

    return walk(jax.device_get(tree))


def flax_variables(module, img=IMG, seed=0):
    init = module.init(jax.random.key(seed), jnp.zeros((1, *img, 3)), train=False)
    return randomize(init)


def images(n=4, img=IMG, seed=1):
    return np.random.default_rng(seed).normal(size=(n, *img, 3)).astype(np.float32)


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= REL_TOL, err


CASES = {
    "overlap_sie": dict(patch_stride=6, sie_cameras=3),
    "no_qkv_bias_scale_tanh_gelu": dict(patch_stride=8, qkv_bias=False, qk_scale=0.1,
                                        gelu_approx=True),
    "fused_attention": dict(patch_stride=6, sie_cameras=3, fused=True),
    "fused_attention_scale": dict(patch_stride=8, qkv_bias=False, qk_scale=0.1, fused=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_vit_reid_matches_flax_in_eval_and_train_mode(case):
    kw = dict(CASES[case])
    fused = kw.pop("fused", False)
    flax = FlaxViT(**SMALL, **kw, use_pallas_attention=fused)
    variables = flax_variables(flax)
    model = ViTReID(**SMALL, **kw, use_fused_attention=fused)
    model.load_state_dict(variables_from_jax("transreid", variables), strict=True)
    x = images()
    cams = np.asarray([0, 2, 1, 2], np.int32)
    extra = {"camera_ids": jnp.asarray(cams)} if kw.get("sie_cameras") else {}
    port_extra = {"camera_ids": torch.from_numpy(cams)} if extra else {}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    want = flax.apply(variables, jnp.asarray(x), train=False, **extra)
    with torch.inference_mode():
        got = model.eval()(xt, **port_extra)
    close(got, want)

    want, upd = flax.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                           **extra)
    got = model.train()(xt, **port_extra)
    close(got.detach(), want)
    np.testing.assert_allclose(model.bottleneck.running_var.numpy(),
                               upd["batch_stats"]["last_bn"]["var"], rtol=1e-5, atol=1e-6)


def test_variables_from_jax_is_the_reference_key_scheme():
    """Key for key and value for value, the JAX package's
    ``vit_reid_to_torch_keys`` (the ``build_transformer`` scheme)."""
    for kw in (dict(patch_stride=6, sie_cameras=3), dict(qkv_bias=False)):
        variables = flax_variables(FlaxViT(**SMALL, **kw))
        got = variables_from_jax("transreid", variables)
        want = vit_reid_to_torch_keys(variables, depth=SMALL["depth"])
        assert got.keys() == want.keys()
        for key in want:
            assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
        model = ViTReID(**SMALL, **kw)
        assert model.state_dict().keys() == got.keys()


@pytest.mark.parametrize("wrapper", ["torchvision", "bare"])
def test_reference_checkpoint_loads_with_its_position_grid_resized(wrapper):
    """A checkpoint trained at a square 4x4 grid (torchvision ``vit_b_16``
    keys under the ViTReID wrapper, or the bare backbone) loads into a 4x2
    model: the same weights and resized position embedding as the JAX
    package's ``vit_reid_from_torch``, and so the same embeddings."""
    square = FlaxViT(**{**SMALL, "img_size": (32, 32)}, patch_stride=8)
    src = flax_variables(square, img=(32, 32))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          vit_reid_to_torch_keys(src, depth=SMALL["depth"], wrapper=wrapper).items()}
    if wrapper == "bare":  # a bare backbone carries no neck
        sd = {k: v for k, v in sd.items() if not k.startswith("last_bn")}
    flax = FlaxViT(**SMALL, patch_stride=8)
    model = ViTReID(**SMALL, patch_stride=8).eval()
    model.load_state_dict(state_from_torch("vit", sd, model), strict=True)
    want_vars = vit_reid_from_torch({k: v.numpy() for k, v in sd.items()},
                                    depth=SMALL["depth"], grid_hw=(4, 2))
    x = images()
    want = flax.apply(want_vars, jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    close(got, want)


@pytest.mark.parametrize("old,new", [((4, 2), (6, 3)), ((6, 4), (3, 2))])
def test_resize_pos_embed_grows_and_shrinks_as_jax_image_resize(old, new):
    pos = np.random.default_rng(5).normal(size=(1, 1 + old[0] * old[1], 8)).astype(np.float32)
    got = resize_pos_embed(pos, new, old)
    want = jax_resize_pos_embed(pos, new, old)
    assert got.shape == want.shape == (1, 1 + new[0] * new[1], 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_drop_path_keeps_samples_at_the_rate_and_rescales_them():
    x = torch.ones(20000, 3, 2)
    gen = torch.Generator().manual_seed(0)
    y = drop_path(x, 0.25, gen)
    kept = y[:, 0, 0] != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert bool((y[~kept] == 0).all())
    assert drop_path(x, 0.0, gen) is x
    again = drop_path(x, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(again, y)  # the generator's stream decides
