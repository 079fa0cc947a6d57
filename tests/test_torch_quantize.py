"""Int8 post-training quantization of the port (``ops/quantize.py``,
``ops/conv_int8.py``, ``FeatureExtractor(quantize='int8')``) against the JAX
package's (``daliid_tpu/ops/quantize.py``, ``daliid_tpu/eval/features.py``),
on the CPU.

Both packages get the same numpy-drawn weights and inputs; the JAX side
runs as ``tests/test_quantize.py`` runs it (eager flax interception, XLA's
int8 convolution and dot on the CPU). The port's scales come from its own
calibration, held against the JAX scales through ``quant_scales_from_jax``.

Tolerances, each with its reason:

- one conv, one Dense layer: bit-equal in f32 and bf16. Both compute the
  exact int32 sum and then the same f32 operations in the same order (the
  conv's ``acc * (s_in * s_w)``, the Dense layer's ``acc * s_in * s_w``);
  measured equal on every case below;
- calibration of a network: absmax within 1e-5 relative (each layer's input
  is an f32 forward of the layers before it, summed in another order);
- a network's int8 embeddings, port against JAX under the same (JAX)
  scales: 1e-2 of the largest entry and cosine > 0.9999. The first layers
  agree bit for bit, but an f32 difference of one ulp in a layer's input can
  move a value across a rounding boundary of the next quantize, which
  changes that input by one quantization step (1/127 of its range); such
  flips carry through the layers after it. Measured on these inputs: at most
  3.7e-3 (EfficientNet-B0), below 1e-6 for the others. The port's own
  scales are held apart (1e-5): an ulp there moves a whole layer's scale
  and flips many values at once (8e-3 seen on another input);
- the extractors' embeddings, port against JAX, each with its own
  calibration: cosine > 0.9999 (the same flips);
- the port's int8 against its floating point: cosine > 0.99, the bound of
  ``tests/test_quantize.py::test_zoo_coverage`` (which holds the JAX side).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daliid_tpu.eval.features import FeatureExtractor as JaxExtractor
from daliid_tpu.models.densenet import DenseNet121ReID as FlaxDenseNet
from daliid_tpu.models.efficientnet import EfficientNetB0ReID as FlaxEfficientNet
from daliid_tpu.models.osnet import OSNetReID as FlaxOSNet
from daliid_tpu.models.resnet import ResNet50ReID as FlaxResNet
from daliid_tpu.models.vit import ViTReID as FlaxViT
from daliid_tpu.ops import quantize as jq
from daliid_tpu_torch.augment.preprocess import normalize_images
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.models.densenet import DenseNet121ReID
from daliid_tpu_torch.models.efficientnet import EfficientNetB0ReID
from daliid_tpu_torch.models.factory import ModelBundle
from daliid_tpu_torch.models.osnet import OSNetReID
from daliid_tpu_torch.models.resnet import Conv, ResNet50ReID
from daliid_tpu_torch.models.torch_port import quant_scales_from_jax, variables_from_jax
from daliid_tpu_torch.models.vit import Linear, ViTReID
from daliid_tpu_torch.ops import quantize as pq
from daliid_tpu_torch.ops.conv_int8 import conv_int8, conv_int8_plain, conv_int32_plain

IMG = (32, 16)
pytestmark = pytest.mark.usefixtures("one_torch_thread")
_RANGES = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.1, 0.1), "var": (0.5, 2.0)}


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the int8 CPU path's many small ops: beside
    the other workers of a parallel test run, OpenMP's eight threads a
    worker oversubscribe the cores and an int8 CLI run takes minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-12)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _draw_variables(module, x_shape, seed=3, **init_kw):
    """Variables at the shapes of the flax init (``eval_shape``), drawn from
    a numpy seed: scales, biases and BN statistics uniform in ``_RANGES``,
    kernels ~ N(0, 1/fan_in)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.zeros(x_shape),
                                                train=False, **init_kw))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in _RANGES:
            return rng.uniform(*_RANGES[name], s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_int8_layers(module, variables, scales, x, **kw):
    """The JAX int8 forward (jitted: eager interception takes tens of
    seconds on the larger trunks) and the module paths that ran in int8
    (those whose interceptor call returned without calling the fp
    forward)."""
    inner = jq.make_quantized_interceptor(scales)
    int8 = set()

    def interceptor(next_fun, args, kwargs, context):
        called = []

        def fp(*a, **k):
            called.append(True)
            return next_fun(*a, **k)

        out = inner(fp, args, kwargs, context)
        mod = context.module
        if (context.method_name == "__call__" and isinstance(mod, (nn.Conv, nn.Dense))
                and not called):
            int8.add(jq._module_path(mod))
        return out

    def run(v, xx):  # traced once: the interceptor records while tracing
        with nn.intercept_methods(interceptor):
            return module.apply(v, xx, **kw)

    out = jax.jit(run)(variables, x)
    return np.asarray(out, np.float32), int8


# ---------------------------------------------------------------- one conv

class OneConv(nn.Module):
    features: int = 8
    kernel: tuple = (1, 1)
    padding: object = 0
    strides: tuple = (1, 1)
    groups: int = 1
    use_bias: bool = False
    dtype: object = jnp.float32

    @nn.compact
    def __call__(self, x, train=False):
        return nn.Conv(self.features, self.kernel, strides=self.strides, padding=self.padding,
                       feature_group_count=self.groups, use_bias=self.use_bias,
                       dtype=self.dtype, name="conv")(x)


# (C in, C out, kernel, stride, padding, groups): 1x1, 3x3 s1, 3x3 s2, the
# 7x7/2 stem on 3 channels, Inception's 1x7 and 7x1, depthwise 3x3 and 5x5/2
CONVS = {
    "1x1": (5, 6, (1, 1), 1, 0, 1),
    "3x3s1": (5, 6, (3, 3), 1, 1, 1),
    "3x3s2": (16, 6, (3, 3), 2, 1, 1),
    "7x7s2c3": (3, 8, (7, 7), 2, 3, 1),
    "1x7": (16, 8, (1, 7), 1, (0, 3), 1),
    "7x1": (16, 8, (7, 1), 1, (3, 0), 1),
    "dw3x3": (8, 8, (3, 3), 1, 1, 8),
    "dw5x5s2": (8, 8, (5, 5), 2, 2, 8),
}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _one_conv(cfg, bias, dtype, seed=0):
    cin, cout, k, stride, pad, groups = cfg
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 9, 7, cin)).astype(np.float32)
    w = (rng.standard_normal((*k, cin // groups, cout)) / 3).astype(np.float32)
    params = {"kernel": w}
    if bias:
        params["bias"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    jd, td = DTYPES[dtype]
    flax_m = OneConv(features=cout, kernel=k, padding=pad, strides=(stride, stride),
                     groups=groups, use_bias=bias, dtype=jd)
    port_m = Conv(cin, cout, k, stride=stride, padding=pad, bias=bias, groups=groups)
    port_m.load_state_dict({"weight": torch.from_numpy(w.transpose(3, 2, 0, 1)),
                            **({"bias": torch.from_numpy(params["bias"])} if bias else {})})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(td).contiguous(
        memory_format=torch.channels_last)
    return flax_m, {"params": {"conv": params}}, jnp.asarray(x).astype(jd), port_m, xt


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("conv", sorted(CONVS))
def test_one_conv_equals_jax_bit_for_bit(conv, bias, dtype):
    flax_m, v, xj, port_m, xt = _one_conv(CONVS[conv], bias, dtype)
    scales = jq.calibrate(flax_m, v, xj)
    port_scales = pq.calibrate(port_m, xt)
    assert port_scales == {"": scales["conv"]}
    want = np.asarray(jq.quantized_apply(flax_m, v, scales, xj).astype(jnp.float32))
    got = pq.quantized_apply(port_m, port_scales, xt)
    assert got.dtype == xt.dtype and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("conv", ["3x3s2", "7x7s2c3", "1x7", "dw5x5s2"])
def test_conv_int8_plain_sum_is_the_int64_convolution(conv):
    """The plain version's int32 sum against a literal int64 convolution in
    numpy, with values at the int8 extremes."""
    cin, cout, (kh, kw), stride, pad, groups = CONVS[conv]
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    rng = np.random.default_rng(1)
    x = rng.integers(-127, 128, (3, cin, 11, 10)).astype(np.int8)
    w = rng.integers(-127, 128, (cout, kh, kw, cin // groups)).astype(np.int8)
    x[0] = 127
    w[0] = -127
    got = conv_int32_plain(torch.from_numpy(x), torch.from_numpy(w), (stride, stride),
                           (ph, pw), groups)
    xp = np.pad(x.astype(np.int64), ((0, 0), (0, 0), (ph, ph), (pw, pw)))
    ho, wo = (xp.shape[2] - kh) // stride + 1, (xp.shape[3] - kw) // stride + 1
    want = np.zeros((3, cout, ho, wo), np.int64)
    per = cout // groups
    for o in range(cout):
        g = o // per
        cg = cin // groups
        for r in range(kh):
            for s in range(kw):
                patch = xp[:, g * cg:(g + 1) * cg, r:r + stride * ho:stride,
                           s:s + stride * wo:stride]
                want[:, o] += np.einsum("bchw,c->bhw", patch, w[o, r, s].astype(np.int64))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the dequantize epilogue: the scales' product first, then the bias
    s_w = torch.from_numpy(rng.uniform(0.001, 0.01, cout).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=cout).astype(np.float32))
    out = conv_int8_plain(torch.from_numpy(x), torch.from_numpy(w), stride, (ph, pw), groups,
                          0.0123, s_w, bias, torch.float32)
    scale = (np.float32(0.0123) * s_w.numpy()).astype(np.float32)
    ref = (want.astype(np.float32) * scale[None, :, None, None]).astype(np.float32)
    np.testing.assert_array_equal(out.numpy(), ref + bias.numpy()[None, :, None, None])


def test_conv_int8_wrapper_checks_and_refuses_other_group_counts():
    x = torch.zeros((1, 8, 5, 5), dtype=torch.int8)
    s_w = torch.ones(8)
    with pytest.raises(NotImplementedError, match="groups=2"):
        conv_int8(x, torch.zeros((8, 3, 3, 4), dtype=torch.int8), 1, 1, 2, 1.0, s_w)
    with pytest.raises(NotImplementedError, match="groups=8 with C 8 and O 16"):
        conv_int8(x, torch.zeros((16, 3, 3, 1), dtype=torch.int8), 1, 1, 8, 1.0,
                  torch.ones(16))
    with pytest.raises(TypeError, match="int8"):
        conv_int8(x.half(), torch.zeros((8, 1, 1, 8), dtype=torch.int8), 1, 0, 1, 1.0, s_w)
    with pytest.raises(ValueError, match="groups 3"):
        conv_int8(x, torch.zeros((8, 1, 1, 8), dtype=torch.int8), 1, 0, 3, 1.0, s_w)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        conv_int8(x.to("meta"), torch.zeros((8, 1, 1, 8), dtype=torch.int8, device="meta"),
                  1, 0, 1, 1.0, s_w.to("meta"))
    before = conv_int8.launches
    conv_int8(x, torch.zeros((8, 1, 1, 8), dtype=torch.int8), 1, 0, 1, 1.0, s_w)
    assert conv_int8.launches == before  # the plain version on the CPU counts no launch


def test_unsupported_dilation_raises():
    m = Conv(3, 4, 3)
    m.dilation = (2, 2)
    x = torch.ones((1, 3, 8, 8))
    with pytest.raises(NotImplementedError, match="dilation"):
        pq.quantized_apply(m, {"": 1.0}, x)


def test_skip_missing_and_degenerate_scales_fall_through():
    _, _, _, m, x = _one_conv(CONVS["3x3s1"], True, "f32", seed=1)
    with torch.inference_mode():
        ref = m(x)
    scales = pq.calibrate(m, x)
    for kw, sc in (({"skip": lambda name: True}, scales), ({}, {}), ({}, {"": 0.0})):
        out = pq.quantized_apply(m, sc, x, **kw)
        assert torch.equal(out, ref)
    assert not torch.equal(pq.quantized_apply(m, scales, x), ref)
    assert "forward" not in vars(m)  # the int8 forward is gone after the call


# ---------------------------------------------------------------- one Dense layer

class OneDense(nn.Module):
    features: int = 192
    use_bias: bool = True
    dtype: object = jnp.float32

    @nn.compact
    def __call__(self, x, train=False):
        return nn.Dense(self.features, use_bias=self.use_bias, dtype=self.dtype, name="fc")(x)


def _one_dense(d_in, d_out, dtype, rows=(3, 7), seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*rows, d_in)).astype(np.float32)
    w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d_out)).astype(np.float32)
    jd, td = DTYPES[dtype]
    port_m = Linear(d_in, d_out)
    port_m.load_state_dict({"weight": torch.from_numpy(w.T.copy()),
                            "bias": torch.from_numpy(b)})
    return (OneDense(features=d_out, dtype=jd), {"params": {"fc": {"kernel": w, "bias": b}}},
            jnp.asarray(x).astype(jd), port_m, torch.from_numpy(x).to(td))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["static", "dynamic", "degenerate"])
def test_one_dense_equals_jax_bit_for_bit(mode, dtype):
    """Static per-tensor (calibrated), dynamic per-row (no entry) and a
    degenerate calibration (absmax 0: dynamic) through ``torch._int_mm``
    with the rows (21, padded to 24), depth (160) and columns (192) as
    they come."""
    flax_m, v, xj, port_m, xt = _one_dense(160, 192, dtype)
    scales = {"static": jq.calibrate(flax_m, v, xj), "dynamic": {},
              "degenerate": {"fc": 0.0}}[mode]
    port_scales = {"" if k == "fc" else k: s for k, s in scales.items()}
    if mode == "static":
        assert pq.calibrate(port_m, xt) == port_scales
    want = np.asarray(jq.quantized_apply(flax_m, v, scales, xj).astype(jnp.float32))
    got = pq.quantized_apply(port_m, port_scales, xt)
    assert got.dtype == xt.dtype and got.shape == (3, 7, 192)
    np.testing.assert_array_equal(got.float().numpy(), want)
    if mode == "degenerate":
        np.testing.assert_array_equal(got.float().numpy(),
                                      pq.quantized_apply(port_m, {}, xt).float().numpy())


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_dense1x1_runs_like_the_flax_dense(mode):
    """A ``Dense1x1`` (a flax Dense held as a 1x1 convolution with bias) at
    widths that take the int8 path runs as the flax Dense over the channel
    axis of a (B, C, 1, 1) input, bit for bit."""
    from daliid_tpu_torch.models.resnet import Dense1x1

    flax_m, v, xj, _, _ = _one_dense(160, 192, "f32", rows=(5,))
    m = Dense1x1(160, 192)
    w = v["params"]["fc"]["kernel"]
    m.load_state_dict({"weight": torch.from_numpy(w.T.copy())[:, :, None, None],
                       "bias": torch.from_numpy(v["params"]["fc"]["bias"])})
    xt = torch.from_numpy(np.array(xj))[:, :, None, None]
    scales = jq.calibrate(flax_m, v, xj) if mode == "static" else {}
    want = np.asarray(jq.quantized_apply(flax_m, v, scales, xj))
    got = pq.quantized_apply(m, {"": scales["fc"]} if scales else {}, xt)
    assert got.shape == (5, 192, 1, 1)
    np.testing.assert_array_equal(got[:, :, 0, 0].numpy(), want)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_dense_int8_semantics_exact_vs_numpy(mode):
    """The literal integer computation (``test_quantize.py``'s numpy
    oracle), at a depth and width that are not multiples of 8 and 5 rows,
    so that ``torch._int_mm``'s operands are padded on every side."""
    rng = np.random.default_rng(6)
    d_in, d_out = 131, 130
    x = rng.standard_normal((5, d_in)).astype(np.float32)
    m = Linear(d_in, d_out)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(rng.standard_normal((d_out, d_in)).astype(np.float32)))
        m.bias.copy_(torch.from_numpy(rng.standard_normal(d_out).astype(np.float32)))
    xt = torch.from_numpy(x)
    scales = {} if mode == "dynamic" else pq.calibrate(m, xt)
    out = pq.quantized_apply(m, scales, xt).numpy()
    w = m.weight.detach().numpy().astype(np.float64).T
    b = m.bias.detach().numpy().astype(np.float64)
    xf = x.astype(np.float64)
    s_in = (np.maximum(np.abs(xf).max(-1, keepdims=True) / 127.0, 1e-12)
            if mode == "dynamic" else scales[""] / 127.0)
    xq = np.clip(np.round(xf / s_in), -127, 127).astype(np.int64)
    s_w = np.maximum(np.abs(w).max(0, keepdims=True) / 127.0, 1e-12)
    wq = np.clip(np.round(w / s_w), -127, 127).astype(np.int64)
    expected = (xq @ wq).astype(np.float64) * s_in * s_w + b
    np.testing.assert_allclose(out, expected.astype(np.float32), rtol=1e-5, atol=1e-5)


def test_dense_below_min_dim_falls_through():
    """Matmuls narrower than ``dense_min_dim`` on either side stay in
    floating point, and ``dense=False`` keeps every Dense layer there."""
    _, _, _, small, x = _one_dense(512, 32, "f32", rows=(4,))
    with torch.inference_mode():
        assert torch.equal(pq.quantized_apply(small, {}, x), small(x))
    _, _, _, big, x = _one_dense(512, 256, "f32", rows=(4,))
    with torch.inference_mode():
        ref = big(x)
    assert torch.equal(pq.quantized_apply(big, {}, x, dense=False), ref)
    assert not torch.equal(pq.quantized_apply(big, {}, x), ref)


# ---------------------------------------------------------------- networks

def test_tiny_resnet_calibration_equals_jax():
    """ResNet-50 with one block a stage on normalized uint8 images: the
    port's calibration against the JAX package's, mapped by
    ``quant_scales_from_jax``: the same layers, each absmax within 1e-5
    relative."""
    flax_m = FlaxResNet(stage_sizes=(1, 1, 1, 1))
    variables = _draw_variables(flax_m, (1, *IMG, 3))
    port_m = ResNet50ReID(stage_sizes=(1, 1, 1, 1)).eval()
    port_m.load_state_dict(variables_from_jax("resnet50", variables), strict=True)
    u8 = np.random.default_rng(0).integers(0, 256, (4, *IMG, 3), dtype=np.uint8)
    from daliid_tpu.augment.preprocess import normalize_images as jax_normalize

    xj = jax_normalize(jnp.asarray(u8))
    xt = normalize_images(torch.from_numpy(u8))
    scales = jq.calibrate(flax_m, variables, xj, train=False)
    mapped = quant_scales_from_jax("resnet50", scales)
    port_scales = pq.calibrate(port_m, xt)
    assert len(scales) == len(mapped) == len(port_scales) == 1 + 4 * 4
    assert port_scales.keys() == mapped.keys()
    assert max(abs(port_scales[k] - mapped[k]) / mapped[k] for k in mapped) < 1e-5


# the families of tests/test_quantize.py::test_zoo_coverage at its sizes
ZOO = {
    "resnet50": (lambda: FlaxResNet(stage_sizes=(1, 1, 1, 1)),
                 lambda: ResNet50ReID(stage_sizes=(1, 1, 1, 1)), IMG),
    "osnet": (FlaxOSNet, OSNetReID, IMG),
    "densenet121": (lambda: FlaxDenseNet(block_sizes=(2, 2, 2, 2), growth=8),
                    lambda: DenseNet121ReID(block_sizes=(2, 2, 2, 2), growth=8), (64, 32)),
    "efficientnetB0": (FlaxEfficientNet, EfficientNetB0ReID, IMG),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_int8_layers_and_embeddings_match_jax(name):
    """Per CNN family: the set of layers that run in int8 is the JAX set
    (OSNet's gate and EfficientNet's squeeze-excitation, 1x1 convolutions in
    torch and Dense layers in flax, stay in floating point in both); int8
    against floating point as ``test_zoo_coverage`` bounds it; port int8
    against JAX int8."""
    flax_fn, port_fn, size = ZOO[name]
    flax_m = flax_fn()
    variables = _draw_variables(flax_m, (1, *size, 3))
    port_m = port_fn().eval()
    port_m.load_state_dict(variables_from_jax(name, variables), strict=True)
    x = np.random.default_rng(7).standard_normal((2, *size, 3)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)

    scales = jq.calibrate(flax_m, variables, xj, train=False)
    port_scales = pq.calibrate(port_m, xt)
    mapped = quant_scales_from_jax(name, scales)
    assert port_scales.keys() == mapped.keys() and len(mapped) == len(scales)
    assert max(abs(port_scales[k] - mapped[k]) / mapped[k] for k in mapped) < 1e-5

    want, jax_int8 = _jax_int8_layers(flax_m, variables, scales, xj, train=False)
    plan = pq.prepare(port_m, port_scales)
    assert set(plan) == set(quant_scales_from_jax(name, {p: 1.0 for p in jax_int8}))
    dense = {k for k, kind in pq.quant_layers(port_m).items() if kind == "dense"}
    assert not dense & set(plan)  # every gate's hidden width is below 128
    assert len(dense) == {"osnet": 12, "efficientnetB0": 32}.get(name, 0)

    with torch.inference_mode():
        fp = port_m(xt).numpy()
    assert _cos(pq.quantized_apply(port_m, port_scales, xt).numpy(), fp).min() > 0.99
    # the int8 arithmetic under the same scales (measured at most 3.7e-3, on
    # efficientnetB0; the others below 1e-6)
    got = pq.quantized_apply(port_m, mapped, xt).numpy()
    assert _rel(got, want) < 1e-2 and _cos(got, want).min() > 0.9999


@pytest.mark.parametrize("size", ["tiny_vit_smoke", "embed192"])
def test_vit_int8_matches_jax(size):
    """The ViT family: the patch embedding (a convolution reached through
    ``proj``'s forward) and, at embed 192, every block's qkv / proj / fc1 /
    fc2 with static scales, then with dynamic ones (only the patch
    embedding calibrated). ``tiny_vit_smoke``'s Dense layers are below 128
    wide and stay in floating point."""
    kw = (dict(embed_dim=32, depth=1, num_heads=2) if size == "tiny_vit_smoke"
          else dict(embed_dim=192, depth=2, num_heads=3))
    common = dict(img_size=IMG, patch_size=8, patch_stride=8, drop_path_rate=0.0, **kw)
    flax_m = FlaxViT(**common)
    variables = _draw_variables(flax_m, (1, *IMG, 3))
    port_m = ViTReID(**common).eval()
    port_m.load_state_dict(variables_from_jax("vit", variables), strict=True)
    x = np.random.default_rng(9).standard_normal((2, *IMG, 3)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    scales = jq.calibrate(flax_m, variables, xj, train=False)
    port_scales = pq.calibrate(port_m, xt)
    mapped = quant_scales_from_jax("vit", scales)
    assert port_scales.keys() == mapped.keys() and len(mapped) == len(scales)
    assert "base.patch_embed.proj" in port_scales
    assert max(abs(port_scales[k] - mapped[k]) / mapped[k] for k in mapped) < 1e-5
    with torch.inference_mode():
        ref = port_m(xt).numpy()
    for sc in (scales, {"patch_embed": scales["patch_embed"]}):
        want, jax_int8 = _jax_int8_layers(flax_m, variables, sc, xj, train=False)
        port_sc = quant_scales_from_jax("vit", sc)
        plan = pq.prepare(port_m, port_sc)
        assert set(plan) == set(quant_scales_from_jax("vit", {p: 1.0 for p in jax_int8}))
        assert len(plan) == (1 if size == "tiny_vit_smoke" else 1 + 2 * 4)
        got = pq.quantized_apply(port_m, port_sc, xt).numpy()
        assert _cos(got, ref).min() > 0.99
        assert _rel(got, want) < 1e-2  # measured 2.1e-7


def test_quant_layers_follow_the_flax_module_kinds():
    """For every family whose key table has Dense layers held as torch
    convolutions, and the transformers: the quantizer's kind of each layer
    is the flax module's kind in ``variables_from_jax``'s table."""
    from daliid_tpu_torch.models import get_model
    from daliid_tpu_torch.models.torch_port import _entries

    flax_mods = {
        "osnet": FlaxOSNet(), "efficientnetB0": FlaxEfficientNet(),
        "densenet121": FlaxDenseNet(block_sizes=(1, 1, 1, 1), growth=8, num_classes=5),
        "vit": FlaxViT(img_size=IMG, patch_size=8, patch_stride=8, embed_dim=32, depth=1,
                       num_heads=2),
    }
    port_mods = {
        "osnet": OSNetReID(), "efficientnetB0": EfficientNetB0ReID(),
        "densenet121": DenseNet121ReID(block_sizes=(1, 1, 1, 1), growth=8, num_classes=5),
        "vit": get_model("tiny_vit_smoke", img_size=IMG).module,
        "inceptionV3": get_model("inceptionV3").module,
    }
    for name, port_m in port_mods.items():
        params = ({} if name == "inceptionV3" else
                  jax.eval_shape(lambda m=flax_mods[name]: m.init(
                      jax.random.key(0), jnp.zeros((1, 64, 32, 3)), train=True))["params"])
        want = {tk: "conv" if kind == "conv" else "dense"
                for tk, _, kind in _entries(name, params)
                if kind in ("conv", "dense", "dense_conv1x1")}
        assert pq.quant_layers(port_m) == want, name


# ---------------------------------------------------------------- the extractor

@pytest.fixture(scope="module")
def tiny_world(tmp_path_factory):
    """The synthetic gallery at 32x16 and a ResNet-50 of one block a stage
    in both packages, with the same drawn weights."""
    from daliid_tpu.data import make_synthetic_dataset
    from daliid_tpu.models.factory import ModelBundle as JaxBundle

    root = tmp_path_factory.mktemp("q8")
    splits, _ = make_synthetic_dataset(str(root / "data"), num_ids=4, imgs_per_id_train=3,
                                       imgs_per_id_test=2, height=IMG[0], width=IMG[1],
                                       with_turbulence=False)
    flax_m = FlaxResNet(stage_sizes=(1, 1, 1, 1))
    variables = _draw_variables(flax_m, (1, *IMG, 3))
    jax_bundle = JaxBundle(module=flax_m, variables=variables, feature_dim=2048, name="tiny")

    def port_bundle():
        m = ResNet50ReID(stage_sizes=(1, 1, 1, 1)).eval()
        m.load_state_dict(variables_from_jax("resnet50", variables), strict=True)
        return ModelBundle(module=m, feature_dim=2048, name="tiny")

    return splits, jax_bundle, port_bundle, variables


@pytest.fixture
def pil_only(monkeypatch):
    """Both packages decode with PIL (the port's native loader would decode
    the JPEGs with other rounding)."""
    import daliid_tpu.data.native_loader as jax_native
    import daliid_tpu_torch.data.native_loader as port_native

    monkeypatch.setattr(jax_native, "native_loader_available", lambda: False)
    monkeypatch.setattr(port_native, "native_loader_available", lambda: False)


def test_feature_extractor_int8_matches_jax(tiny_world, pil_only):
    """Lazy calibration on the first batch, the same scales and embeddings
    as the JAX extractor's; the tiled short batch; an empty extract that
    never calibrates; new weights that drop the scales."""
    splits, jax_bundle, port_bundle, _ = tiny_world
    gallery = [str(p) for p in splits["gallery"].paths]  # 8 images: one batch of 8
    jq_ex = JaxExtractor(jax_bundle, img_size=IMG, batch_size=8, quantize="int8")
    port_fp = FeatureExtractor(port_bundle(), img_size=IMG, batch_size=8)
    port_q = FeatureExtractor(port_bundle(), img_size=IMG, batch_size=8, quantize="int8")
    assert port_q.quant_scales is None
    want = jq_ex.extract(gallery)
    got = port_q.extract(gallery)
    mapped = quant_scales_from_jax("resnet50", jq_ex.quant_scales)
    assert port_q.quant_scales.keys() == mapped.keys() and len(mapped) == 17
    assert max(abs(port_q.quant_scales[k] - mapped[k]) / mapped[k] for k in mapped) < 1e-5
    assert _cos(got, want).min() > 0.9999
    assert _cos(got, port_fp.extract(gallery)).min() > 0.995

    port_q.update_variables(port_q.bundle.module.state_dict())
    assert port_q.quant_scales is None and not port_q._calib_final
    empty = port_q.extract([])
    assert empty.shape == (0, 2048) and port_q.quant_scales is None
    port_q.extract(gallery)
    assert port_q.quant_scales is not None

    # a 1-image extract calibrates on the image tiled to the batch, as the
    # JAX extractor does
    short = FeatureExtractor(port_bundle(), img_size=IMG, batch_size=8, quantize="int8")
    one = short.extract(gallery[:1])
    jax_short = JaxExtractor(jax_bundle, img_size=IMG, batch_size=8, quantize="int8")
    jax_one = jax_short.extract(gallery[:1])
    assert one.shape == (1, 2048) and _cos(one, jax_one).min() > 0.9999
    explicit = FeatureExtractor(port_bundle(), img_size=IMG, batch_size=8, quantize="int8")
    explicit.calibrate(np.tile(explicit._decode_paths(gallery[:1]), (8, 1, 1, 1)))
    assert short.quant_scales == explicit.quant_scales


def test_feature_extractor_calib_batches(tiny_world, pil_only, tmp_path):
    """``calib_batches=2`` folds the first real batch into the running max
    after a batch of near-constant gray images, as in JAX; with fewer real
    batches than ``calib_batches`` the stream's end finalizes."""
    from PIL import Image

    splits, jax_bundle, port_bundle, _ = tiny_world
    rng = np.random.default_rng(3)
    gray = []
    for i in range(8):
        arr = (128 + rng.integers(-2, 3, size=(*IMG, 3))).astype(np.uint8)
        gray.append(str(tmp_path / f"g{i}.jpg"))
        Image.fromarray(arr).save(gray[-1], quality=95)
    paths = gray + [str(p) for p in splits["gallery"].paths]
    one = FeatureExtractor(port_bundle(), img_size=IMG, batch_size=8, quantize="int8")
    two = FeatureExtractor(port_bundle(), img_size=IMG, batch_size=8, quantize="int8",
                           calib_batches=2)
    one.extract(paths)
    got = two.extract(paths)
    assert set(two.quant_scales) == set(one.quant_scales)
    assert all(two.quant_scales[k] >= one.quant_scales[k] for k in one.quant_scales)
    assert max(two.quant_scales[k] / one.quant_scales[k] for k in one.quant_scales) > 3
    jax_two = JaxExtractor(jax_bundle, img_size=IMG, batch_size=8, quantize="int8",
                           calib_batches=2)
    want = jax_two.extract(paths)
    mapped = quant_scales_from_jax("resnet50", jax_two.quant_scales)
    assert max(abs(two.quant_scales[k] - mapped[k]) / mapped[k] for k in mapped) < 1e-5
    assert _cos(got[8:], want[8:]).min() > 0.9999

    few = FeatureExtractor(port_bundle(), img_size=IMG, batch_size=8, quantize="int8",
                           calib_batches=5)
    few.extract(paths[8:])
    assert few._calib_final and few.quant_scales is not None
    with pytest.raises(ValueError, match="calib_batches"):
        FeatureExtractor(port_bundle(), img_size=IMG, quantize="int8", calib_batches=0)


def test_feature_extractor_rejects_unknown_mode():
    with pytest.raises(ValueError, match="int8"):
        FeatureExtractor(ModelBundle(module=ResNet50ReID(stage_sizes=(1, 1, 1, 1)),
                                     feature_dim=2048, name="x"), quantize="fp4")
