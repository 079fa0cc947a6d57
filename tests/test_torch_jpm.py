"""TransReID-JPM and the margin heads of the PyTorch port against the JAX
package, on the CPU in f32.

A flax ``TransReIDJPM`` at a small size (embed 64, 2 heads of 32, depth 3,
so a trunk of 2 blocks; 38x16 images of 8x8 patches at stride 6, 12
patches, so 4 local chunks of 3 tokens) with 5 classes and SIE over 3
cameras, its LayerNorm, bias and BN leaves drawn from a numpy seed, is
carried into the port by ``variables_from_jax``; both run one numpy batch.

Tolerances: embeddings and logits within 1e-4 of the largest magnitude (f32
summation order; measured at most 4e-6); ``shuffle_unit`` exact (a
permutation); margin logits within rtol 1e-5 and their gradients within
rtol 1e-4 plus 1e-6 of the largest entry (arccos near the clip amplifies
f32 rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daliid_tpu import margins as JM
from daliid_tpu.models.torch_port import transreid_jpm_to_torch_keys
from daliid_tpu.models.transreid_jpm import TransReIDJPM as FlaxJPM
from daliid_tpu.models.transreid_jpm import shuffle_unit as jax_shuffle_unit
from daliid_tpu_torch import margins as M
from daliid_tpu_torch.models.torch_port import state_from_torch, variables_from_jax
from daliid_tpu_torch.models.transreid_jpm import TransReIDJPM, shuffle_unit
from test_torch_vit import close, flax_variables, images

IMG = (38, 16)
SMALL = dict(img_size=IMG, patch_size=8, patch_stride=6, embed_dim=64, depth=3, num_heads=2,
             drop_path_rate=0.0, sie_cameras=3, num_classes=5)


def pair(**kw):
    flax = FlaxJPM(**{**SMALL, **kw})
    variables = flax_variables(flax, img=IMG)
    port_kw = {**SMALL, **kw}
    port_kw["use_fused_attention"] = port_kw.pop("use_pallas_attention", False)
    model = TransReIDJPM(**port_kw)
    model.load_state_dict(variables_from_jax("transreid_jpm", variables), strict=True)
    return flax, variables, model


def run_both(flax, variables, model, train, labels=None):
    x = images(n=6, img=IMG)
    cams = np.asarray([1, 2, 0, 2, 1, 0], np.int32)
    kw = {"camera_ids": jnp.asarray(cams)}
    port_kw = {"camera_ids": torch.from_numpy(cams)}
    if labels is not None:
        kw["labels"] = jnp.asarray(labels)
        port_kw["labels"] = torch.from_numpy(labels)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if train:
        want, upd = flax.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                               **kw)
        return model.train()(xt, **port_kw), want, upd
    with torch.inference_mode():
        got = model.eval()(xt, **port_kw)
    return got, flax.apply(variables, jnp.asarray(x), train=False, **kw), None


@pytest.mark.parametrize("neck_feat", ["before", "after"])
def test_jpm_eval_embedding_matches_flax(neck_feat):
    got, want, _ = run_both(*pair(neck_feat=neck_feat), train=False)
    assert got.shape == (6, 5 * 64)
    close(got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_jpm_train_scores_features_and_neck_stats_match_flax(fused):
    flax, variables, model = pair(use_pallas_attention=fused)
    (scores, feats), (want_s, want_f), upd = run_both(flax, variables, model, train=True)
    assert len(scores) == len(want_s) == 5 and len(feats) == len(want_f) == 5
    for g, w in zip(scores + feats, list(want_s) + list(want_f)):
        close(g.detach(), w)
    for i, name in enumerate(["bottleneck"] + [f"bottleneck_{i}" for i in range(1, 5)]):
        np.testing.assert_allclose(getattr(model, name).running_mean.numpy(),
                                   upd["batch_stats"][name]["mean"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["arcface", "cosface", "amsoftmax", "circle"])
def test_jpm_margin_head_scores_the_global_feature(kind):
    labels = np.asarray([0, 1, 4, 2, 3, 1], np.int32)
    flax, variables, model = pair(id_loss_type=kind)
    (scores, feats), (want_s, _), _ = run_both(flax, variables, model, train=True,
                                               labels=labels)
    assert len(scores) == len(want_s) == 1 and len(feats) == 5
    close(scores[0].detach(), want_s[0])


@pytest.mark.parametrize("kind,kw", [("arcface", {}), ("cosface", {"m": 0.2}),
                                     ("amsoftmax", {}), ("circle", {"s": 32.0})])
def test_margin_logits_and_gradients_match_jax(kind, kw):
    rng = np.random.default_rng(6)
    emb = rng.normal(size=(8, 16)).astype(np.float32)
    w = rng.normal(size=(16, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 8).astype(np.int32)
    g = rng.normal(size=(8, 5)).astype(np.float32)
    want = JM.margin_logits(kind, jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels), **kw)
    want_ge, want_gw = jax.grad(
        lambda e, w_: jnp.sum(JM.margin_logits(kind, e, w_, jnp.asarray(labels), **kw) * g),
        argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(w))
    te, tw = torch.from_numpy(emb).requires_grad_(), torch.from_numpy(w).requires_grad_()
    got = M.margin_logits(kind, te, tw, torch.from_numpy(labels), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    (got * torch.from_numpy(g)).sum().backward()
    for a, b in ((te.grad, want_ge), (tw.grad, want_gw)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6 * np.abs(b).max())
    with pytest.raises(KeyError, match="unknown margin head"):
        M.margin_logits("sphereface", te, tw, torch.from_numpy(labels))


@pytest.mark.parametrize("n_tokens,group", [(13, 2), (12, 2), (10, 3)])
def test_shuffle_unit_is_the_jax_permutation(n_tokens, group):
    """Shift 5 and group shuffle, including token counts that the group
    does not divide (12 - 1 = 11 tokens: the second-to-last is repeated)."""
    x = np.random.default_rng(0).normal(size=(2, n_tokens, 3)).astype(np.float32)
    got = shuffle_unit(torch.from_numpy(x), 5, group).numpy()
    want = np.asarray(jax_shuffle_unit(jnp.asarray(x), 5, group))
    assert np.array_equal(got, want)


def test_jpm_variables_from_jax_and_a_margin_checkpoint():
    """``variables_from_jax`` is, key for key and value for value, the JAX
    package's ``transreid_jpm_to_torch_keys``; a reference margin-head
    checkpoint (one ``classifier``, no local heads, the trunk's unused
    last block and norm present) loads into the port."""
    _, variables, model = pair()
    got = variables_from_jax("transreid_jpm", variables)
    want = transreid_jpm_to_torch_keys(variables, depth=SMALL["depth"])
    assert got.keys() == want.keys() == model.state_dict().keys()
    for key in want:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    ref = {k: v for k, v in got.items() if not k.startswith("classifier_")}
    ref.update({"base.blocks.2.norm1.weight": torch.ones(64), "base.norm.weight": torch.ones(64),
                "base.fc.weight": torch.zeros(7, 64)})
    loaded = state_from_torch("transreid_jpm", {"module." + k: v for k, v in ref.items()}, model)
    model.load_state_dict(loaded, strict=True)
    assert torch.equal(model.classifier.weight, got["classifier.weight"])
    assert 0.0 < float(model.classifier_1.weight.detach().std()) < 0.002
    plain = TransReIDJPM(**{**SMALL, "num_classes": 0})
    plain.load_state_dict(state_from_torch("transreid_jpm", ref, plain), strict=True)
