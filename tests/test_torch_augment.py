"""Kernel K1 (fused train augmentation) in the PyTorch port against the JAX
package, on the CPU.

On a CPU tensor the port's ``fused_augment`` computes its plain version;
it is held against the Pallas kernel ``_augment_core`` in interpret mode on
the same numpy scalar table. Tolerances: f32 within atol 2e-5 (the two sum
the mean gray in different orders; measured about 1e-6); bf16 within one
bf16 ulp of the larger magnitude, or 2e-5 where that ulp is finer (values
near zero, where both round f32 values that differ by the f32 tolerance).
The CUDA kernel itself is held against the same plain version on the card
by ``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daliid_tpu.ops.fused_augment import _augment_core, _draw_scalars
from daliid_tpu_torch.augment import train_augment as train_augment_mod
from daliid_tpu_torch.ops import fused_augment as fa
from daliid_tpu_torch.ops.fused_augment import draw_scalars, fused_augment, fused_augment_plain

REPO = Path(__file__).resolve().parents[1]
DEFAULTS = (0.4, 0.3, 0.4, (0.05, 0.30), (0.3, 3.3))


def _edge_rows(table, h, w, pad):
    """Rows with crop offsets at 0 and 2*pad, both flips, and erase
    rectangles touching each border (and one covering the whole image)."""
    t = table.copy()
    for i in range(t.shape[0]):
        oy, ox = (0, 2 * pad) if i % 2 else (2 * pad, 0)
        eh, ew = max(1, h // (2 + i % 3)), max(1, w // (2 + i % 2))
        ey, ex = [(0, 0), (h - eh, w - ew), (0, w - ew), (h - eh, 0)][i % 4]
        if i % 5 == 4:
            ey, ex, eh, ew = 0, 0, h, w
        t[i, [0, 1, 2, 6, 7, 8, 9]] = [oy, ox, i % 2, ey, ex, eh, ew]
    return t


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


def _assert_k1_close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    if dtype == "float32":
        tol = np.full_like(diff, 2e-5)
    else:
        tol = np.maximum(_bf16_ulp(np.maximum(np.abs(got), np.abs(want))), 2e-5)
    assert (diff <= tol).all(), (diff.max(), int((diff > tol).sum()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,pad", [((3, 32, 16), 10), ((3, 32, 16), 4),
                                       ((2, 37, 19), 10), ((2, 37, 19), 4)])
def test_plain_matches_interpret_mode_pallas(shape, pad, dtype):
    b, h, w = shape
    rng = np.random.default_rng(b * 100 + pad)
    drawn = draw_scalars(b, h, w, pad, *DEFAULTS, torch.Generator().manual_seed(pad)).numpy()
    # drawn rows, then the edge cases, in one batch
    scal = np.concatenate([drawn, _edge_rows(np.tile(drawn, (3, 1)), h, w, pad)])
    images = rng.integers(0, 256, (scal.shape[0], h, w, 3), dtype=np.uint8)
    want = np.asarray(_augment_core(jnp.asarray(images), jnp.asarray(scal), pad,
                                    getattr(jnp, dtype), interpret=True))
    got = fused_augment(torch.from_numpy(images), torch.from_numpy(scal), pad,
                        getattr(torch, dtype))
    assert got.shape == (scal.shape[0], 3, h, w) and got.dtype == getattr(torch, dtype)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _assert_k1_close(got.permute(0, 2, 3, 1).float().numpy(), want, dtype)


def test_zero_border_becomes_contrast_of_the_mean_gray():
    """A crop offset at 0 shifts in a zero border, which contrast moves to
    (1 - fc) * mean_gray before saturation (whose gray there is 0)."""
    h, w, pad = 8, 6, 2
    images = np.full((1, h, w, 3), 255, np.uint8)
    scal = np.zeros((1, 16), np.float32)
    # oy = ox = 0: the top two rows and left two columns are border; fb =
    # fc = fs = 1 would be the identity, so take fc = 0.5; a 1-pixel erase
    # in the far corner
    scal[0, :10] = [0, 0, 0, 1.0, 0.5, 1.0, h - 1, w - 1, 1, 1]
    out = fused_augment_plain(torch.from_numpy(images), torch.from_numpy(scal), pad,
                              torch.float32)
    x = out.permute(0, 2, 3, 1)[0].numpy() * np.asarray([0.229, 0.224, 0.225]) \
        + np.asarray([0.485, 0.456, 0.406])
    mean_gray = (h - pad) * (w - pad) / (h * w)  # white inside, zero border
    np.testing.assert_allclose(x[0, 0], 0.5 * mean_gray, atol=1e-6)
    np.testing.assert_allclose(x[h - 2, w - 2], 0.5 * mean_gray + 0.5, atol=1e-6)
    np.testing.assert_allclose(x[h - 1, w - 1], 0.0, atol=1e-6)


@pytest.mark.parametrize("h,w,pad", [(256, 128, 10), (37, 19, 4)])
def test_draw_scalars_bounds_and_determinism(h, w, pad):
    n = 4096
    s = draw_scalars(n, h, w, pad, *DEFAULTS, torch.Generator().manual_seed(3))
    again = draw_scalars(n, h, w, pad, *DEFAULTS, torch.Generator().manual_seed(3))
    other = draw_scalars(n, h, w, pad, *DEFAULTS, torch.Generator().manual_seed(4))
    assert s.shape == (n, 16) and s.dtype == torch.float32
    assert torch.equal(s, again) and not torch.equal(s, other)
    s = s.numpy()
    oy, ox, flip, fb, fc, fs, ey, ex, eh, ew = s[:, :10].T
    assert (s[:, 10:] == 0).all()
    for v in (oy, ox, ey, ex, eh, ew):
        assert (v == np.round(v)).all()
    assert oy.min() == ox.min() == 0 and oy.max() == ox.max() == 2 * pad
    assert set(np.unique(flip)) == {0.0, 1.0}
    for f, b in ((fb, 0.4), (fc, 0.3), (fs, 0.4)):
        assert f.min() >= 1 - b and f.max() <= 1 + b
    assert (eh >= 1).all() and (eh <= h).all() and (ew >= 1).all() and (ew <= w).all()
    assert (ey >= 0).all() and (ey + eh <= h).all() and (ex >= 0).all() and (ex + ew <= w).all()
    area = eh * ew / (h * w)
    assert area.max() <= 0.30 * 1.0001 and np.median(area) > 0.05


def test_draw_scalars_distributions_match_jax():
    """Column means over 4,096 draws: the two generators give different
    numbers from the same distributions, so each mean agrees within six
    standard errors of the difference of two independent means."""
    n, h, w, pad = 4096, 256, 128, 10
    s = draw_scalars(n, h, w, pad, *DEFAULTS, torch.Generator().manual_seed(1)).numpy()[:, :10]
    j = np.asarray(_draw_scalars(jax.random.key(0), n, h, w, pad, *DEFAULTS))[:, :10]
    se = np.sqrt((s.var(axis=0) + j.var(axis=0)) / n)
    assert (np.abs(s.mean(axis=0) - j.mean(axis=0)) <= 6 * se).all(), \
        (s.mean(axis=0), j.mean(axis=0), se)


def test_train_augment_draws_from_the_generator_then_augments():
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 32, 16, 3),
                                                                 dtype=np.uint8))
    got = train_augment_mod.train_augment(images, torch.Generator().manual_seed(7),
                                          dtype=torch.float32)
    scal = draw_scalars(4, 32, 16, 10, *DEFAULTS, torch.Generator().manual_seed(7))
    assert torch.equal(got, fused_augment_plain(images, scal, 10, torch.float32))


def test_wrapper_on_meta_and_empty_input_launches_nothing():
    fused_augment.launches = 0
    images = torch.zeros((2, 8, 4, 3), dtype=torch.uint8, device="meta")
    scal = torch.zeros((2, 16), dtype=torch.float32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        fused_augment(images, scal, 10)
    out = fused_augment(images[:0], scal[:0], 10)
    assert out.shape == (0, 3, 8, 4) and out.dtype == torch.bfloat16
    assert fused_augment.launches == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    images = torch.zeros((2, 8, 4, 3), dtype=torch.uint8)
    scal = torch.zeros((2, 16))
    with pytest.raises(TypeError, match="uint8"):
        fused_augment(images.float(), scal, 10)
    with pytest.raises(ValueError, match="scalars"):
        fused_augment(images, scal[:, :10], 10)
    with pytest.raises(TypeError, match="output dtype"):
        fused_augment(images, scal, 10, torch.float16)
    with pytest.raises(ValueError, match="pad"):
        fused_augment(images, scal, -1)


def test_ctypes_signature_matches_the_c_entry_point():
    """The wrapper's argtypes name every parameter of ``extern "C"
    fused_augment`` in ``csrc/fused_augment.cu`` (a miscount only shows when
    the library is loaded on the card)."""
    src = (REPO / "daliid_tpu_torch" / "csrc" / "fused_augment.cu").read_text()
    params = re.search(r'extern "C" int fused_augment\(([^)]*)\)', src).group(1).split(",")
    kinds = ["ptr" if "*" in p else "int" for p in params]
    assert kinds == ["ptr" if t.__name__ == "c_void_p" else "int" for t in fa.ARGTYPES]
