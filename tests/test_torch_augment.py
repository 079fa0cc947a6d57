"""Kernel K1 (fused train augmentation) in the PyTorch port against the JAX
package, on the CPU.

On a CPU tensor the port's ``fused_augment`` computes its plain version;
it is held against the Pallas kernel ``_augment_core`` in interpret mode on
the same numpy scalar table. Tolerances: f32 within atol 2e-5 (the two sum
the mean gray in different orders; measured about 1e-6); bf16 within one
bf16 ulp of the larger magnitude, or 2e-5 where that ulp is finer (values
near zero, where both round f32 values that differ by the f32 tolerance).
The CUDA kernel itself is held against the same plain version on the card
by ``chip_smoke.py``. Its design (bands of rows, a mean gray summed in
double and combined in a fixed order) is emulated here in plain torch and
numpy and held against the interpret-mode kernel within 2e-5 (f32).
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


# ---- the CUDA kernel's design, emulated in plain torch and numpy ----
def _kernel_constant(name: str) -> int:
    src = (REPO / "daliid_tpu_torch" / "csrc" / "fused_augment.cu").read_text()
    return eval(re.search(rf"constexpr int {name} = ([^;]+);", src).group(1))


def _brightened(images, scal):
    """Steps 3-4 of every source pixel, f32 in the kernel's order → (v, gray)."""
    fb = scal[:, 3].view(-1, 1, 1, 1)
    v = torch.clamp(images.float() * (1.0 / 255.0) * fb, 0.0, 1.0)
    gray = v[..., 0] * 0.299 + v[..., 1] * 0.587 + v[..., 2] * 0.114
    return v, gray


def _band_sums(gray, scal, pad):
    """Per image, the kernel's band sums of the gray over the source pixels
    inside the crop: each CTA's band (and sub-bands) in row-major order,
    thread t taking elements t, t + T, ... in double, a warp tree
    (``__shfl_down_sync`` 16, 8, 4, 2, 1), then the warps in order."""
    n_cl, n_thr, cap = (_kernel_constant(k) for k in ("kCluster", "kThreads", "kStageBytes"))
    b, h, w = gray.shape
    band = -(-h // n_cl)
    sub = max(1, min(band, cap // (3 * w)))
    out = np.zeros((b, n_cl))
    for i in range(b):
        dy, dx = int(scal[i, 0]) - pad, int(scal[i, 1]) - pad
        g = gray[i].double().numpy()
        for rank in range(n_cl):
            y0 = min(h, rank * band)
            y1 = min(h, y0 + band)
            acc = np.zeros(n_thr)
            for ys in range(y0, y1, sub):
                rows = g[max(ys + dy, 0):max(min(min(y1, ys + sub) + dy, h), 0),
                         max(0, dx):min(w, w + dx)].reshape(-1)
                for t in range(n_thr):
                    for x in rows[t::n_thr]:
                        acc[t] += x
            for w_ in range(n_thr // 32):
                lanes = acc[32 * w_:32 * w_ + 32].copy()
                for off in (16, 8, 4, 2, 1):
                    lanes[:off] = lanes[:off] + lanes[off:2 * off]
                acc[w_] = lanes[0]
            s = 0.0
            for w_ in range(n_thr // 32):
                s += acc[w_]
            out[i, rank] = s
    return out


def _k1_emulation(images, scal, pad):
    """``csrc/fused_augment.cu`` in f32: the mean gray from the band sums
    added in rank order, every other step the plain version's."""
    b, h, w, _ = images.shape
    sums = _band_sums(_brightened(images, scal)[1], scal, pad)
    total = np.zeros(b)
    for k in range(sums.shape[1]):
        total = total + sums[:, k]
    mean_gray = torch.from_numpy(total / (h * w)).float().view(b, 1, 1, 1)
    # the plain version on the crop, with this mean gray in place of its own
    oy, ox = scal[:, 0].long(), scal[:, 1].long()
    flip = scal[:, 2] > 0.5
    fc, fs = scal[:, 4].view(b, 1, 1, 1), scal[:, 5].view(b, 1, 1, 1)
    ys, xs = torch.arange(h), torch.arange(w)
    src_x = torch.where(flip[:, None], w - 1 - xs[None, :], xs[None, :]) + ox[:, None] - pad
    src_y = ys[None, :] + oy[:, None] - pad
    valid = (((src_y >= 0) & (src_y < h))[:, :, None] & ((src_x >= 0) & (src_x < w))[:, None, :])
    bi = torch.arange(b).view(b, 1, 1)
    crop = images[bi, src_y.clamp(0, h - 1)[:, :, None], src_x.clamp(0, w - 1)[:, None, :]]
    crop = torch.where(valid[..., None], crop, torch.zeros((), dtype=torch.uint8))
    x, gray = _brightened(crop, scal)
    gray = gray[..., None]
    x = torch.clamp(mean_gray + fc * (x - mean_gray), 0.0, 1.0)
    x = torch.clamp(gray + fs * (x - gray), 0.0, 1.0)
    ey, ex, eh, ew = (scal[:, k].long().view(b, 1, 1) for k in (6, 7, 8, 9))
    inside = ((ys.view(1, h, 1) >= ey) & (ys.view(1, h, 1) < ey + eh)
              & (xs.view(1, 1, w) >= ex) & (xs.view(1, 1, w) < ex + ew))
    x = torch.where(inside[..., None], torch.zeros(()), x)
    mean = torch.tensor([0.485, 0.456, 0.406])
    std = torch.tensor([0.229, 0.224, 0.225])
    return (x - mean) / std, total


@pytest.mark.parametrize("shape,pad", [((3, 32, 16), 10), ((2, 37, 19), 4),
                                       ((1, 512, 256), 10)])
def test_kernel_design_emulation_matches_interpret_mode_pallas(shape, pad):
    """Bands, sub-bands (512 x 256 overflows one stage) and the fixed-order
    double combine, within 2e-5 (f32) of the interpret-mode kernel."""
    b, h, w = shape
    band = -(-h // _kernel_constant("kCluster"))
    assert (band * 3 * w > _kernel_constant("kStageBytes")) == (h == 512)
    rng = np.random.default_rng(b * 1000 + h)
    drawn = draw_scalars(b, h, w, pad, *DEFAULTS, torch.Generator().manual_seed(h)).numpy()
    scal = np.concatenate([drawn, _edge_rows(np.tile(drawn, (2, 1)), h, w, pad)])
    images = rng.integers(0, 256, (scal.shape[0], h, w, 3), dtype=np.uint8)
    want = np.asarray(_augment_core(jnp.asarray(images), jnp.asarray(scal), pad, jnp.float32,
                                    interpret=True))
    got, _ = _k1_emulation(torch.from_numpy(images), torch.from_numpy(scal), pad)
    _assert_k1_close(got.numpy(), want, "float32")


def test_default_knobs_gray_sum_is_exact_in_any_band_order():
    """With the train defaults (fb >= 0.6) every nonzero gray is an f32 of at
    least 2^-12, so a multiple of 2^-35, and a 2^15-pixel image sums below
    2^15: 50 bits, inside double's 53. The double sum is then exact, the same
    bits in the kernel's order, the bands reversed, or any order."""
    b, h, w, pad = 4, 256, 128, 10
    scal = draw_scalars(b, h, w, pad, *DEFAULTS, torch.Generator().manual_seed(3))
    scal[0, 3] = 0.6  # the least brightness factor the defaults draw
    images = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (b, h, w, 3),
                                                                dtype=np.uint8))
    images[0, 0, 0] = torch.tensor([0, 0, 1], dtype=torch.uint8)  # the least nonzero gray
    gray = _brightened(images, scal)[1]
    nz = gray[gray > 0].double().numpy()
    assert nz.min() >= 2.0 ** -12
    assert np.all(np.floor(nz * 2.0 ** 35) == nz * 2.0 ** 35)
    sums = _band_sums(gray, scal, pad)
    in_order = np.zeros(b)
    for k in range(sums.shape[1]):
        in_order = in_order + sums[:, k]
    reversed_ = np.zeros(b)
    for k in reversed(range(sums.shape[1])):
        reversed_ = reversed_ + sums[:, k]
    rng = np.random.default_rng(4)
    for i in range(b):
        dy, dx = int(scal[i, 0]) - pad, int(scal[i, 1]) - pad
        g = gray[i, max(dy, 0):min(h + dy, h), max(dx, 0):min(w + dx, w)].double().numpy()
        shuffled = 0.0
        for x in rng.permutation(g.reshape(-1)):
            shuffled += x
        assert in_order[i] == reversed_[i] == shuffled == float(np.sum(g))
