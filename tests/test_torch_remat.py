"""``--remat`` in the PyTorch port (CPU): activation checkpointing of the
transformer blocks (``models/vit.py``).

- ``vit_small``'s shape and TransReID-JPM at a small size (embed 32, 2
  heads, depth 3, 8x8 patches on 32x16 images), drop-path 0.3 in train
  mode, through SDPA and through K4's plain version: under ``full`` and
  ``tuned`` the f32 forward, every parameter gradient and the drop-path
  generator's state after the backward are bit-equal to ``none``'s (the
  same operations in the same order; the uniforms are drawn before each
  checkpointed region);
- the port under ``remat`` against the JAX package under ``remat`` on the
  same weights (drop-path 0: JAX's key cannot be replayed in torch): the
  train-mode forward within 1e-4 of its largest entry (the ViT tests'
  tolerance), every parameter gradient ``g`` within ``GRAD_TOL * |g| +
  1e-6 * |G|`` in L2 norm, ``G`` the whole gradient (f32 summation order;
  measured below 4e-6 relative, but for ViT's final LayerNorm bias, whose
  gradient the train-mode BN neck cancels to about 1e-6 of ``|G|``: there
  the relative difference is O(1), with or without remat, as in the JAX
  package's own remat test);
- the factory passes ``remat`` to every block of the ``REMAT_MODELS``,
  which are the JAX package's; an unknown mode raises ``ValueError`` on
  both sides, and the train CLI refuses ``--remat`` for a CNN before any
  work.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daliid_tpu.models import factory as jax_factory
from daliid_tpu.models.transreid_jpm import TransReIDJPM as FlaxJPM
from daliid_tpu.models.vit import ViTReID as FlaxViT
from daliid_tpu.models.vit import remat_block_cls
from daliid_tpu_torch.cli import train as port_train
from daliid_tpu_torch.models import factory as port_factory
from daliid_tpu_torch.models.factory import init_weights
from daliid_tpu_torch.models.torch_port import params_from_jax, variables_from_jax
from daliid_tpu_torch.models.transreid_jpm import TransReIDJPM
from daliid_tpu_torch.models.vit import REMAT_MODES, Block, ViTReID, check_remat

IMG = (32, 16)
SMALL = dict(img_size=IMG, patch_size=8, embed_dim=32, depth=3, num_heads=2)
# vit_small's peculiarities (vit_pytorch.py:461-468) at the small width
MODELS = {"vit_small": dict(patch_stride=8, mlp_ratio=3.0, qkv_bias=False, qk_scale=32 ** -0.5),
          "transreid_jpm": dict(patch_stride=6, num_classes=5)}
GRAD_TOL = 1e-4
_RANGES = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.1, 0.1), "var": (0.5, 2.0)}


def _port(name, remat, drop=0.0, fused=False):
    cls = TransReIDJPM if name == "transreid_jpm" else ViTReID
    model = cls(**SMALL, **MODELS[name], drop_path_rate=drop, remat=remat,
                use_fused_attention=fused)
    init_weights(model, torch.Generator().manual_seed(1))
    return model.train()


def _images(n=6, seed=2):
    return np.random.default_rng(seed).normal(size=(n, *IMG, 3)).astype(np.float32)


def _loss(out):
    """A scalar of every output, each weighted by a fixed pattern."""
    if isinstance(out, tuple):  # JPM in train mode: (scores, feats)
        out = list(out[0]) + list(out[1])
    out = out if isinstance(out, list) else [out]
    return sum((o * torch.linspace(-1.0, 1.0, o.numel()).view_as(o)).sum() for o in out)


def _step(model, x, seed=3):
    gen = torch.Generator().manual_seed(seed)
    out = model(x, generator=gen)
    loss = _loss(out)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}, gen.get_state()


@pytest.mark.parametrize("fused", [False, True], ids=["sdpa", "k4_plain"])
@pytest.mark.parametrize("remat", ["full", "tuned"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_remat_is_bit_equal_to_none_with_drop_path(name, remat, fused):
    x = torch.from_numpy(_images()).permute(0, 3, 1, 2)
    loss0, grads0, state0 = _step(_port(name, "none", 0.3, fused), x)
    loss1, grads1, state1 = _step(_port(name, remat, 0.3, fused), x)
    assert torch.equal(loss1, loss0)
    assert set(grads1) == set(grads0)
    for key, g in grads0.items():
        assert torch.equal(grads1[key], g), key
    assert torch.equal(state1, state0)
    # the masks were drawn: another generator seed changes the loss
    assert not torch.equal(_step(_port(name, remat, 0.3, fused), x, seed=4)[0], loss0)


def _randomized(tree, seed=3):
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else (rng.uniform(*_RANGES[k], np.shape(v)).astype(np.float32)
                      if k in _RANGES else np.asarray(v))
                for k, v in node.items()}

    return walk(jax.device_get(tree))


@pytest.mark.parametrize("remat", ["full", "tuned"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_remat_matches_jax_remat(name, remat):
    flax_cls = FlaxJPM if name == "transreid_jpm" else FlaxViT
    flax = flax_cls(**SMALL, **MODELS[name], drop_path_rate=0.0, remat=remat)
    x = _images()
    variables = _randomized(flax.init(jax.random.key(0), jnp.zeros((1, *IMG, 3)), train=False))

    def jloss(params):
        out, _ = flax.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=True, mutable=["batch_stats"])
        if isinstance(out, tuple):
            out = list(out[0]) + list(out[1])
        out = out if isinstance(out, list) else [out]
        return sum((o * jnp.linspace(-1.0, 1.0, o.size).reshape(o.shape)).sum()
                   for o in out), out

    (want, outs), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    model = _port(name, remat)
    key = "transreid_jpm" if name == "transreid_jpm" else "transreid"
    model.load_state_dict(variables_from_jax(key, variables), strict=True)
    out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    loss = _loss(out)
    loss.backward()
    got_outs = (list(out[0]) + list(out[1])) if isinstance(out, tuple) else [out]
    for g, w in zip(got_outs, outs):
        w = np.asarray(w)
        assert np.abs(g.detach().numpy() - w).max() <= 1e-4 * np.abs(w).max()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    want_grads = params_from_jax(key, jax.device_get(jgrads))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want_grads)
    total = np.sqrt(sum(float(np.linalg.norm(w.numpy())) ** 2 for w in want_grads.values()))
    for k, w in want_grads.items():
        diff = float(np.linalg.norm(grads[k].numpy() - w.numpy()))
        assert diff <= GRAD_TOL * float(np.linalg.norm(w.numpy())) + 1e-6 * total, k


@pytest.mark.parametrize("name", sorted(port_factory.REMAT_MODELS))
def test_factory_passes_remat_to_every_block(name):
    module = port_factory.get_model(name, img_size=(64, 32), remat="tuned").module
    blocks = [m for m in module.modules() if isinstance(m, Block)]
    assert blocks and all(b.remat == "tuned" for b in blocks)


def test_remat_sets_and_refusals_match_jax(tmp_path):
    assert port_factory.REMAT_MODELS == jax_factory.REMAT_MODELS
    assert REMAT_MODES == ("none", "full", "tuned")
    with pytest.raises(ValueError, match="remat"):
        remat_block_cls("everything")
    with pytest.raises(ValueError, match="remat"):
        check_remat("everything")
    with pytest.raises(ValueError, match="remat"):
        port_factory.get_model("vit_small", img_size=(64, 32), remat="everything")
    args = port_train.build_argparser().parse_args(
        ["--dataset", "Synthetic", "--data_root", str(tmp_path), "--device", "cpu",
         "--model_name", "osnet", "--remat", "tuned"])
    with pytest.raises(SystemExit, match="only applies to the transformer family"):
        port_train.main(args)
    assert not (tmp_path / "Synthetic").exists()  # refused before any data work
    with pytest.raises(SystemExit):  # argparse's choices, as in the JAX CLI
        port_train.build_argparser().parse_args(["--dataset", "Synthetic", "--remat", "some"])
