"""The training slice's losses in the PyTorch port against ``daliid_tpu.losses``
on the CPU: values, on-device diagnostics and gradients (``jax.grad``).

Inputs are made with numpy and handed to both. Tolerances: values within
rtol 1e-5 (f32; the two sum in different orders), gradients within
rtol 1e-4 plus atol 1e-6 of the largest gradient entry (the gradients pass
through log-softmax and top-k with tau = 0.05, which amplifies f32 rounding
by 1/tau).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daliid_tpu import losses as JL
from daliid_tpu_torch import losses as L

TAU = 0.05


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _batch(seed=0, n=12, d=16, classes=4):
    """A paired PK-like batch: labels in pairs, distortions [0, s], the last
    pair masked out as padding."""
    rng = np.random.default_rng(seed)
    fvs = _unit(rng, n, d)
    labels = np.repeat(rng.integers(0, classes, n // 2), 2).astype(np.int32)
    dist = np.stack([np.zeros(n // 2), rng.integers(1, 6, n // 2)], axis=1).reshape(-1)
    mask = np.ones(n, bool)
    mask[-2:] = False
    return rng, fvs, labels, dist.astype(np.int32), mask


def _close(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("epoch", [0, 3, 10])
def test_distortion_weights_match(epoch):
    for n_mins in (L.N_MIN_6, L.N_MIN_13):
        got = L.distortion_weights(epoch, 10, n_mins).numpy()
        _close(got, JL.distortion_weights(epoch, 10, n_mins))
    assert L.N_MIN_6 == JL.N_MIN_6 and L.N_MIN_13 == JL.N_MIN_13


@pytest.mark.parametrize("masked", [False, True])
def test_weighted_center_loss_value_aux_and_grad(masked):
    rng, fvs, labels, dist, mask = _batch(1)
    centers = _unit(rng, 4, 16)
    mask = mask if masked else None
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(f):
        return JL.weighted_center_loss(f, jnp.asarray(labels), jnp.asarray(dist),
                                       jnp.asarray(centers), 2.0, 10.0, tau=TAU,
                                       sample_mask=jmask)

    (want, jaux), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(fvs))
    f = torch.from_numpy(fvs).requires_grad_(True)
    got, aux = L.weighted_center_loss(f, torch.from_numpy(labels), torch.from_numpy(dist),
                                      torch.from_numpy(centers), 2.0, 10.0, tau=TAU,
                                      sample_mask=None if mask is None else torch.from_numpy(mask))
    got.backward()
    _close(got.item(), want)
    _close(aux["batch_acc_bal"].item(), jaux["batch_acc_bal"])
    _close(aux["avg_max_prob"].item(), jaux["avg_max_prob"])
    np.testing.assert_array_equal(aux["predicted"].numpy(), np.asarray(jaux["predicted"]))
    _grad_close(f.grad.numpy(), jgrad)


def test_center_loss_balanced_accuracy_counts_predicted_only_classes():
    """getACCBal divides by the union of ground-truth and predicted classes."""
    centers = np.eye(3, 4, dtype=np.float32)
    fvs = np.asarray([centers[0], centers[1], centers[1], centers[2]])  # sample 3 -> class 2
    labels = np.asarray([0, 1, 1, 1], np.int32)  # class 2 is never a ground truth
    args = (np.zeros(4, np.int32), centers)
    got = L.weighted_center_loss(torch.from_numpy(fvs), torch.from_numpy(labels),
                                 *map(torch.from_numpy, args), 1, 10, tau=TAU)[1]
    want = JL.weighted_center_loss(jnp.asarray(fvs), jnp.asarray(labels),
                                   *map(jnp.asarray, args), 1, 10, tau=TAU)[1]
    assert got["batch_acc_bal"].item() == pytest.approx((1.0 + 2 / 3) / 3)
    _close(got["batch_acc_bal"].item(), want["batch_acc_bal"])


def _proxy_table(rng, d=16):
    """Four classes with num_proxies = 3 slots each: class 0 owns 3, class 1
    owns 2, class 2 owns 1 and class 3 none (its slots are label -1)."""
    owned = [3, 2, 1, 0]
    proxies = _unit(rng, 12, d)
    plabels = -np.ones(12, np.int32)
    for c, k in enumerate(owned):
        plabels[3 * c:3 * c + k] = c
    return proxies, plabels


@pytest.mark.parametrize("masked", [False, True])
def test_weighted_proxy_loss_value_and_grad(masked):
    rng, fvs, labels, dist, mask = _batch(2)
    labels[:2] = 3  # a pair of class 3, which owns no proxy: no positive
    proxies, plabels = _proxy_table(rng)
    mask = mask if masked else None

    def jloss(f, p):
        return JL.weighted_proxy_loss(f, jnp.asarray(labels), jnp.asarray(dist), p,
                                      jnp.asarray(plabels), 3.0, 10.0, tau=TAU,
                                      sample_mask=None if mask is None else jnp.asarray(mask),
                                      p_max=3)

    want, (jg_f, jg_p) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(fvs),
                                                                   jnp.asarray(proxies))
    f = torch.from_numpy(fvs).requires_grad_(True)
    p = torch.from_numpy(proxies).requires_grad_(True)
    got = L.weighted_proxy_loss(f, torch.from_numpy(labels), torch.from_numpy(dist), p,
                                torch.from_numpy(plabels), 3.0, 10.0, tau=TAU,
                                sample_mask=None if mask is None else torch.from_numpy(mask),
                                p_max=3)
    got.backward()
    _close(got.item(), want)
    assert torch.isfinite(f.grad).all() and torch.isfinite(p.grad).all()
    _grad_close(f.grad.numpy(), jg_f)
    _grad_close(p.grad.numpy(), jg_p)
    # the class-3 samples have no positive and take no gradient; padding proxies none
    assert (f.grad[:2] == 0).all() and (p.grad[plabels < 0] == 0).all()


def test_weighted_proxy_loss_default_bound_checks_the_largest_class():
    rng, fvs, labels, dist, _ = _batch(3)
    proxies, plabels = _proxy_table(rng)
    args = [torch.from_numpy(a) for a in (fvs, labels, dist, proxies, plabels)]
    want = JL.weighted_proxy_loss(*map(jnp.asarray, (fvs, labels, dist, proxies, plabels)),
                                  1.0, 10.0, tau=TAU)
    _close(L.weighted_proxy_loss(*args, 1.0, 10.0, tau=TAU).item(), want)
    one_class = torch.zeros(70, dtype=torch.int32)  # one class owning 70 > 64 proxies
    with pytest.raises(ValueError, match="p_max"):
        L.weighted_proxy_loss(args[0], args[1], args[2], torch.zeros(70, 16), one_class,
                              1.0, 10.0)


@pytest.mark.parametrize("masked", [False, True])
def test_paired_distortion_loss_value_and_grad(masked):
    rng, fvs, labels, dist, mask = _batch(4)
    pair_mask = mask[1::2] if masked else None

    def jloss(f):
        return JL.paired_distortion_loss(
            f[0::2], f[1::2], jnp.asarray(dist[1::2]), 2.0, 10.0,
            pair_mask=None if pair_mask is None else jnp.asarray(pair_mask))

    want, jg = jax.value_and_grad(jloss)(jnp.asarray(fvs))
    f = torch.from_numpy(fvs).requires_grad_(True)
    got = L.paired_distortion_loss(
        f[0::2], f[1::2], torch.from_numpy(dist[1::2]), 2.0, 10.0,
        pair_mask=None if pair_mask is None else torch.from_numpy(pair_mask))
    got.backward()
    _close(got.item(), want)
    _grad_close(f.grad.numpy(), jg)
