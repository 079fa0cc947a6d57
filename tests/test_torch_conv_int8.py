"""``conv_int8`` with a floating-point input (``ops/conv_int8.py``): the
route that quantizes in the kernel's loads, its plain version and the
layouts the kernel reads, on the CPU.

The kernel itself (``csrc/conv_int8.cu``) runs only on the card, where
``chip_smoke.py`` holds it against the plain version bit for bit. Here:

- the float route of the wrapper equals ``quantize_sym`` followed by the
  int8 route, bit for bit, in bf16 and f32, at the shapes of
  ``test_torch_quantize.py`` and ``chip_smoke.py``'s ragged ones, with and
  without bias, in int32, f32 and bf16 out (both are exact: the same f32
  quantize, then an exact integer sum and the same f32 epilogue);
- the quantize on planted values (exact halves, the clamp's edges, signed
  zeros, subnormals, infinities) equals JAX's ``_quantize_sym`` and the
  kernel's order of operations (the clamp before the rounding) exactly;
- the wrapper's refusals;
- ``pack_weights`` is zero padding and a permutation that
  ``unpack_weights`` undoes, laid out as the kernel's swizzled stages;
- an emulation of the kernel's producers (the tap walk of the implicit GEMM,
  the staged window and its word table, the depthwise window and strips),
  written in the kernel's integer steps, equals the im2col of the quantized
  input and the plain sums exactly.

All inputs are drawn with numpy from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daliid_tpu.ops import quantize as jq
from daliid_tpu_torch.ops import conv_int8 as ci
from daliid_tpu_torch.ops import quantize as pq
from daliid_tpu_torch.ops.conv_int8 import (
    conv_int8,
    conv_int32_plain,
    pack_weights,
    packed_numel,
    quantize_sym,
    unpack_weights,
)

# (C in, C out, kernel, stride, padding, groups): test_torch_quantize.py's
# CONVS and chip_smoke.py's RAGGED_CONVS (but the wide 3x3, whose point is
# a window too large for shared memory)
SHAPES = {
    "1x1": (5, 6, (1, 1), 1, 0, 1),
    "3x3s1": (5, 6, (3, 3), 1, 1, 1),
    "3x3s2": (16, 6, (3, 3), 2, 1, 1),
    "7x7s2c3": (3, 8, (7, 7), 2, 3, 1),
    "1x7": (16, 8, (1, 7), 1, (0, 3), 1),
    "7x1": (16, 8, (7, 1), 1, (3, 0), 1),
    "dw3x3": (8, 8, (3, 3), 1, 1, 8),
    "dw5x5s2": (8, 8, (5, 5), 2, 2, 8),
    "ragged 3x3 C=5": (5, 6, (3, 3), 1, 1, 1),
    "ragged 1x7 C=24": (24, 40, (1, 7), 1, (0, 3), 1),
    "ragged dw5x5s2 C=30": (30, 30, (5, 5), 2, 2, 30),
    "ragged 1x1 C=24": (24, 40, (1, 1), 1, 0, 1),
    "ragged 1x1/2 C=24": (24, 40, (1, 1), 2, 0, 1),
}
OUTS = {"int32": torch.int32, "f32": torch.float32, "bf16": torch.bfloat16}
S_IN = np.float32(0.0123)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _inputs(name, dtype, seed=0, batch=2, hw=(9, 7)):
    """(x, wq, s_w, bias) for one of SHAPES: x spread over +-1.2 * 127 *
    s_in with exact half-way points planted, in ``dtype``."""
    cin, cout, (kh, kw), _, _, groups = SHAPES[name]
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.2, 1.2, (batch, cin, *hw)).astype(np.float32) * 127 * S_IN
    flat = x.reshape(-1)
    n = flat.size // 3
    flat[:n] = (rng.integers(-128, 128, n) + np.float32(0.5)) * S_IN
    wq = rng.integers(-127, 128, (cout, kh, kw, cin // groups)).astype(np.int8)
    s_w = rng.uniform(0.5, 1.5, cout).astype(np.float32) / 127 / 64
    bias = rng.normal(size=cout).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype).contiguous(memory_format=torch.channels_last)
    return xt, torch.from_numpy(wq), torch.from_numpy(s_w), torch.from_numpy(bias)


@pytest.mark.parametrize("out", sorted(OUTS))
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_float_route_equals_quantize_then_int8_route(name, dtype, bias, out):
    _, _, _, stride, padding, groups = SHAPES[name]
    x, wq, s_w, b = _inputs(name, torch.float32 if dtype == "f32" else torch.bfloat16)
    b = b if bias else None
    got = conv_int8(x, wq, stride, padding, groups, float(S_IN), s_w, b, OUTS[out])
    xq = quantize_sym(x, torch.tensor(S_IN)).contiguous(memory_format=torch.channels_last)
    want = conv_int8(xq, wq, stride, padding, groups, float(S_IN), s_w, b, OUTS[out])
    assert got.dtype == OUTS[out] and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


def _planted(scale: np.float32) -> np.ndarray:
    """Exact halves (k + 0.5) * s for k in [-130, 129], +-127.5 * s, values
    beyond the clamp, signed zeros, subnormals and infinities, in f32."""
    k = np.arange(-130, 130, dtype=np.float32)
    tiny = np.finfo(np.float32).tiny
    vals = np.concatenate([
        (k + np.float32(0.5)) * scale, k * scale,
        np.float32([127.5, -127.5, 126.5, -126.5, 127.49, -127.51]) * scale,
        np.float32([1e3, -1e3, 3e38, -3e38]) * scale,
        np.float32([0.0, -0.0, tiny / 2, -tiny / 4, tiny, np.inf, -np.inf]),
        np.nextafter((k + np.float32(0.5)) * scale, np.float32(np.inf)),
        np.nextafter((k + np.float32(0.5)) * scale, np.float32(-np.inf)),
    ]).astype(np.float32)
    return vals


@pytest.mark.parametrize("scale", [0.0123, 1.0, 3.7e-5, 0.1])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_on_planted_values_equals_jax(dtype, scale):
    s = np.float32(scale)
    vals = _planted(s)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    xt = torch.from_numpy(vals).to(td)
    x32 = xt.float().numpy()  # the values the input type holds; bf16 to f32 is exact
    want = np.asarray(jq._quantize_sym(jnp.asarray(x32).astype(jd), jnp.float32(s)))
    got = quantize_sym(xt, torch.tensor(s)).numpy()
    np.testing.assert_array_equal(got, want)
    # the kernel's order: a true f32 division, the clamp, then round half to even
    with np.errstate(over="ignore"):
        kernel = np.rint(np.clip(x32 / s, np.float32(-127), np.float32(127))).astype(np.int8)
    np.testing.assert_array_equal(kernel, want)
    # and the float route of the wrapper on a 1x1 identity convolution
    x4 = xt.view(1, 1, 1, -1)
    out = conv_int8(x4, torch.ones((1, 1, 1, 1), dtype=torch.int8), 1, 0, 1, float(s),
                    torch.ones(1), None, torch.int32)
    np.testing.assert_array_equal(out.view(-1).numpy(), want.astype(np.int32))


def test_wrapper_refusals():
    x = torch.zeros((1, 8, 5, 5), dtype=torch.bfloat16)
    wq = torch.zeros((8, 1, 1, 8), dtype=torch.int8)
    s_w = torch.ones(8)
    for dtype in (torch.float16, torch.float64, torch.int16, torch.uint8, torch.int32):
        with pytest.raises(TypeError, match="int8 .quantized., bfloat16 or float32"):
            conv_int8(x.to(dtype), wq, 1, 0, 1, 1.0, s_w)
    with pytest.raises(TypeError, match="wq must be int8"):
        conv_int8(x, wq.float(), 1, 0, 1, 1.0, s_w)
    for bad in (0.0, -1.0, float("nan"), float("inf"), float("-inf")):
        with pytest.raises(ValueError, match="finite s_in > 0"):
            conv_int8(x, wq, 1, 0, 1, bad, s_w)
        with pytest.raises(ValueError, match="finite s_in > 0"):
            conv_int8(x.float(), wq, 1, 0, 1, bad, s_w)
    conv_int8(x.to(torch.int8), wq, 1, 0, 1, 0.0, s_w)  # int8: s_in only scales the result
    with pytest.raises(ValueError, match="one device"):
        conv_int8(x.to("meta"), wq, 1, 0, 1, 1.0, s_w)
    with pytest.raises(ValueError, match="one device"):
        conv_int8(x, wq, 1, 0, 1, 1.0, s_w, w_packed=pack_weights(wq, 1).to("meta"))
    with pytest.raises(NotImplementedError, match="depthwise 7x7"):
        conv_int8(x, torch.zeros((8, 7, 7, 1), dtype=torch.int8), 1, 3, 8, 1.0, s_w)
    with pytest.raises(NotImplementedError, match="depthwise 3x3"):
        conv_int8(x, torch.zeros((8, 3, 3, 1), dtype=torch.int8), 3, 1, 8, 1.0, s_w)
    before = conv_int8.launches
    conv_int8(x, wq, 1, 0, 1, 1.0, s_w)
    assert conv_int8.launches == before  # the plain version on the CPU counts no launch


def test_wrapper_refuses_a_packing_of_other_weights():
    x = torch.zeros((1, 8, 5, 5), dtype=torch.bfloat16)
    wq = torch.zeros((8, 3, 3, 8), dtype=torch.int8)
    for bad in (pack_weights(torch.zeros((8, 5, 5, 8), dtype=torch.int8), 1),
                pack_weights(wq, 1).to(torch.uint8)):
        with pytest.raises(ValueError, match="w_packed is not pack_weights"):
            conv_int8(x, wq, 1, 1, 1, 1.0, torch.ones(8), w_packed=bad)
    conv_int8(x, wq, 1, 1, 1, 1.0, torch.ones(8), w_packed=pack_weights(wq, 1))


PACK_SHAPES = [((6, 3, 3, 5), 1), ((64, 7, 7, 3), 1), ((40, 1, 7, 24), 1), ((32, 3, 3, 128), 1),
               ((300, 1, 1, 64), 1), ((33, 1, 1, 8), 1), ((768, 16, 16, 3), 1),
               ((30, 5, 5, 1), 30), ((144, 3, 3, 1), 144)]


@pytest.mark.parametrize("shape,groups", PACK_SHAPES)
def test_pack_weights_is_a_padded_permutation(shape, groups):
    rng = np.random.default_rng(3)
    wq = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    wq[wq == 0] = 1  # every real byte nonzero: the padding is the only zero
    packed = pack_weights(wq, groups)
    assert packed.dtype == torch.int8 and packed.numel() == packed_numel(shape, groups)
    assert int((packed != 0).sum()) == wq.numel()
    assert torch.equal(unpack_weights(packed, shape, groups), wq)
    o, kh, kw, cg = shape
    if groups != 1:
        return
    # the layout: [n tile][stage][row][chunk][16], chunk d of row n holding
    # K bytes (d ^ (n % 8)) * 16 .. of that stage
    c4 = cg if cg % 8 == 0 else -(-cg // 4) * 4
    bn = ci.block_n(o)
    k = kh * kw * c4
    w2 = np.zeros((-(-o // bn) * bn, -(-k // 128) * 128), np.int8)
    w2[:o, :k] = np.pad(wq.numpy(), ((0, 0), (0, 0), (0, 0), (0, c4 - cg))).reshape(o, k)
    p = packed.numpy().reshape(w2.shape[0] // bn, w2.shape[1] // 128, bn, 8, 16)
    for nt in range(p.shape[0]):
        for ks in range(p.shape[1]):
            for n in range(bn):
                for d in range(8):
                    c = d ^ (n % 8)
                    np.testing.assert_array_equal(
                        p[nt, ks, n, d], w2[nt * bn + n, ks * 128 + 16 * c:ks * 128 + 16 * c + 16])


def test_quant_conv_hands_the_float_input_to_the_kernel(monkeypatch):
    """``_QuantConv`` passes the layer's input itself: no int8 copy, no
    quantize pass before the kernel."""
    seen = []
    real = pq.conv_int8

    def spy(x, *a, **kw):
        seen.append(x.dtype)
        return real(x, *a, **kw)

    monkeypatch.setattr(pq, "conv_int8", spy)
    m = torch.nn.Conv2d(8, 16, 3, padding=1, bias=False)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 8, 6, 5)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        out = pq._QuantConv(m, 3.0)(x.to(dtype))
        assert out.dtype == dtype
    assert seen == [torch.float32, torch.bfloat16]


# ---------------------------------------------------------------- emulation
def _im2col(xq_nhwc, kh, kw, sh, sw, ph, pw, c4):
    """(B*Ho*Wo, kh*kw*c4) int64 rows in K order (r, s, c), channels padded
    to c4, padding taps 0."""
    b, h, w, c = xq_nhwc.shape
    xp = np.pad(xq_nhwc.astype(np.int64), ((0, 0), (ph, ph), (pw, pw), (0, c4 - c)))
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    cols = [xp[:, r:r + sh * (ho - 1) + 1:sh, s:s + sw * (wo - 1) + 1:sw, :]
            for r in range(kh) for s in range(kw)]
    return np.concatenate(cols, axis=-1).reshape(b * ho * wo, kh * kw * c4), ho, wo


def _emulate_igemm_a(xq, kh, kw, sh, sw, ph, pw):
    """The gathering route's producers: 128-row tiles; thread (ch, rb) walks
    the taps of the two 8-channel pieces of its chunk 128 K a stage."""
    b, h, w, c = xq.shape
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    m_all, k = b * ho * wo, kh * kw * c
    nks = -(-k // 128)
    a = np.zeros((m_all, nks * 128), np.int64)
    flat = xq.reshape(-1)
    for m0 in range(0, m_all, 128):
        rows = []
        for r in range(128):
            m = m0 + r
            if m >= m_all:
                rows.append((0, 0, 0, 0))
                continue
            bi, p = divmod(m, ho * wo)
            oh, ow = divmod(p, wo)
            rows.append((bi * h * w, oh * sh - ph, ow * sw - pw, 1))
        for pt in range(128):
            ch, rb = pt & 7, pt >> 3
            tr, ts, tc = [0, 0], [0, 0], [0, 0]
            for u in range(2):
                kk = ch * 16 + u * 8
                rs = kk // c
                tc[u] = kk - rs * c
                tr[u], ts[u] = rs // kw, rs % kw
            dc, drs = 128 % c, 128 // c
            for ks in range(nks):
                for i in range(8):
                    row = rb + 16 * i
                    ex, ey, ez, ew = rows[row]
                    for u in range(2):
                        ih, iw = ey + tr[u], ez + ts[u]
                        if ew and tr[u] < kh and 0 <= ih < h and 0 <= iw < w:
                            at = (ex + ih * w + iw) * c + tc[u]
                            a[m0 + row, ks * 128 + ch * 16 + u * 8:][:8] = flat[at:at + 8]
                for u in range(2):
                    tc[u] += dc
                    ts[u] += drs
                    if tc[u] >= c:
                        tc[u] -= c
                        ts[u] += 1
                    while ts[u] >= kw:
                        ts[u] -= kw
                        tr[u] += 1
    return a[:, :k]


def _fastdiv(d):
    """The kernel's FastDiv::set: (mul, shr) with n / d == umulhi(n, mul) >>
    shr for 0 <= n < 2^31 (mul 0: d == 1)."""
    if d == 1:
        return 0, 0
    lg = (d - 1).bit_length()  # ceil(log2(d))
    return ((1 << (31 + lg)) + d - 1) // d, lg - 1


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 8, 12, 24, 36, 134, 144, 160, 1030, 2048, 65537])
def test_fastdiv_divides_like_integer_division(d):
    mul, shr = _fastdiv(d)
    assert 0 <= mul < 1 << 32
    rng = np.random.default_rng(d)
    ns = np.concatenate([np.arange(0, 4 * d + 8), rng.integers(0, 1 << 31, 4096),
                         np.array([(1 << 31) - 1, (1 << 31) - d, (1 << 30) + d])])
    for n in ns.tolist():
        got = n if mul == 0 else ((n * mul) >> 32) >> shr
        assert got == n // d, (n, d)


def _emulate_staged_a(xq, kh, kw, sh, sw, ph, pw, bm):
    """The staged route: ``bm``-pixel tiles inside one image (128, or 64
    where that window would not fit), the window of input rows quantized once
    with channels padded to C4, the word table, 4-byte reads."""
    b, h, w, c = xq.shape
    c4 = -(-c // 4) * 4
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    k = kh * kw * c4
    nq, pitch, cols = k // 4, (w + 2 * pw) * c4, w + 2 * pw
    words = []
    for q in range(nq):
        tap, cc = divmod(4 * q, c4)
        r, s = divmod(tap, kw)
        words.append(r * pitch + s * c4 + cc)
    a = np.zeros((b * ho * wo, k), np.int64)
    tiles_img = -(-ho * wo // bm)
    for mt in range(b * tiles_img):
        bi, t = divmod(mt, tiles_img)
        p0 = t * bm
        m_count = min(bm, ho * wo - p0)
        oh_a, oh_b = p0 // wo, (p0 + m_count - 1) // wo
        rows_in = (oh_b - oh_a) * sh + kh
        window = np.zeros(rows_in * pitch, np.int64)
        for wr in range(rows_in):
            for wc in range(cols):
                ih, iw = oh_a * sh - ph + wr, wc - pw
                if 0 <= ih < h and 0 <= iw < w:
                    window[wr * pitch + wc * c4:][:c] = xq[bi, ih, iw]
        for r in range(m_count):
            oh, ow = divmod(p0 + r, wo)
            ex = (oh - oh_a) * sh * pitch + ow * sw * c4
            for q in range(nq):
                a[bi * ho * wo + p0 + r, 4 * q:4 * q + 4] = window[ex + words[q]:][:4]
    return a, c4


def _emulate_depthwise(xq, wq, sh, sw, ph, pw):
    """The depthwise route: the host's tile choice, the block's window of
    quantized inputs, thread (cg, strip) summing 4 outputs of a row for 8
    channels from the window."""
    b, h, w, c = xq.shape
    kh, kw = wq.shape[1:3]
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    segw = 4 if wo > 8 else (2 if wo > 4 else 1)
    tw, th = 4 * segw, 1
    while th < ho and th * segw < 64:
        th *= 2
    strips = th * segw
    cgn = min(256 // strips, -(-c // 8))
    cb = 8 * cgn
    wr_n, wc_n = (th - 1) * sh + kh, (tw - 1) * sw + kw
    wcp = wc_n | 1
    taps = wq.reshape(c, kh * kw).astype(np.int64)
    out = np.zeros((b, ho, wo, c), np.int64)
    tiles_h, tiles_w = -(-ho // th), -(-wo // tw)
    for blk in range(b * tiles_h * tiles_w):
        bi, rem = divmod(blk, tiles_h * tiles_w)
        th0, tw0 = (rem // tiles_w) * th, (rem % tiles_w) * tw
        for cb0 in range(0, c, cb):
            win = np.zeros((wr_n, wcp, cb), np.int64)
            for wr in range(wr_n):
                for wc in range(wc_n):
                    ih, iw = th0 * sh - ph + wr, tw0 * sw - pw + wc
                    if 0 <= ih < h and 0 <= iw < w:
                        n = min(cb, c - cb0)
                        win[wr, wc, :n] = xq[bi, ih, iw, cb0:cb0 + n]
            for tid in range(cgn * strips):
                cg, strip = tid % cgn, tid // cgn
                row, seg = strip % th, strip // th
                c0, oh, ow0 = cb0 + 8 * cg, th0 + row, tw0 + 4 * seg
                if c0 >= c or oh >= ho or ow0 >= wo:
                    continue
                n = min(8, c - c0)
                for i in range(4):
                    ow = ow0 + i
                    if ow >= wo:
                        break
                    acc = np.zeros(n, np.int64)
                    for r in range(kh):
                        for s in range(kw):
                            px = win[row * sh + r, 4 * sw * seg + sw * i + s, 8 * cg:8 * cg + n]
                            acc += px * taps[c0:c0 + n, r * kw + s]
                    out[bi, oh, ow, c0:c0 + n] = acc
    return out


EMULATED = {  # name: (C, O, kernel, stride, padding, groups, batch, H, W)
    "c8 3x3 C=16": (16, 8, (3, 3), 1, 1, 1, 2, 9, 7),
    "c8 3x3/2 C=24": (24, 8, (3, 3), 2, 1, 1, 3, 8, 6),
    "c8 1x7 C=24": (24, 8, (1, 7), 1, (0, 3), 1, 2, 5, 9),
    "c8 1x1 C=136": (136, 8, (1, 1), 1, 0, 1, 1, 12, 12),
    "c8 7x1 C=8": (8, 8, (7, 1), 1, (3, 0), 1, 2, 9, 7),
    "c4 7x7/2 C=3": (3, 8, (7, 7), 2, 3, 1, 2, 20, 13),
    "c4 3x3 C=5": (5, 8, (3, 3), 1, 1, 1, 2, 9, 7),
    "c4 3x3/2 C=3 no pad": (3, 8, (3, 3), 2, 0, 1, 2, 21, 15),
    "c4 16x16/16 C=3": (3, 8, (16, 16), 16, 0, 1, 1, 64, 32),
    "depthwise 3x3 C=40": (40, 40, (3, 3), 1, 1, 40, 2, 19, 11),
    "depthwise 5x5/2 C=30": (30, 30, (5, 5), 2, 2, 30, 2, 7, 5),
    "depthwise 3x3/2 C=16": (16, 16, (3, 3), 2, 1, 16, 1, 9, 40),
    "depthwise 5x5 C=8": (8, 8, (5, 5), 1, 2, 8, 1, 3, 3),
}


@pytest.mark.parametrize("name", sorted(EMULATED))
def test_kernel_design_emulation(name):
    c, o, (kh, kw), stride, padding, groups, b, h, w = EMULATED[name]
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    rng = np.random.default_rng(7)
    xq = rng.integers(-127, 128, (b, h, w, c)).astype(np.int8)
    wq = rng.integers(-127, 128, (o, kh, kw, c // groups)).astype(np.int8)
    layout = ci.weight_layout(c // groups, groups)
    assert layout == name.split()[0]
    want = conv_int32_plain(torch.from_numpy(xq).permute(0, 3, 1, 2), torch.from_numpy(wq),
                            (sh, sw), (ph, pw), groups).permute(0, 2, 3, 1).numpy()
    if layout == "depthwise":
        got = _emulate_depthwise(xq, wq, sh, sw, ph, pw)
        np.testing.assert_array_equal(got, want)
        return
    # C % 8 == 0: the staged window or the gathering route (the kernel picks
    # by shape); C % 8 != 0: the staged window
    emulated = [_emulate_staged_a(xq, kh, kw, sh, sw, ph, pw, bm) for bm in (64, 128)]
    if layout == "c8":
        emulated.append((_emulate_igemm_a(xq, kh, kw, sh, sw, ph, pw), c))
    for a, c4 in emulated:
        ref, ho, wo = _im2col(xq, kh, kw, sh, sw, ph, pw, c4)
        np.testing.assert_array_equal(a, ref)
    # B as the kernel's stages hold it (pack_weights, unswizzled), K in the same order
    w2 = unpack_weights(pack_weights(torch.from_numpy(wq), 1), wq.shape, 1).numpy()
    b2 = np.pad(w2, ((0, 0), (0, 0), (0, 0), (0, c4 - c))).reshape(o, -1).astype(np.int64)
    np.testing.assert_array_equal((a @ b2.T).reshape(b, ho, wo, o), want)
