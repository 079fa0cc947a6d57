"""K4's backward in the PyTorch port on the CPU: the routing of both
autograd Functions' backward, the wrappers' checks, the arguments and
counts of a launch, the biased kernel's chunking, and the CUDA kernels' bf16
arithmetic emulated in plain torch.

On CPU tensors the backward is :func:`attention_backward` (held against the
JAX VJP in ``tests/test_torch_attention.py``); on CUDA tensors the wrapper
launches the kernels of ``csrc/attention_grad.cu`` or raises. The kernels
themselves are checked on the card by ``tests/test_torch_attention_grad_card.py``.

The emulation follows the kernels' design: S and dP as f32 sums of exact
bf16 products, P from the log-sum-exp (unbiased) or times 1/l (biased), delta
the f32 row sum of P o dP, and P and dS entering dV, dQ and dK as bf16(x) +
bf16(x - bf16(x)); it is held to the card's check, one bf16 ulp of the
larger magnitude or 2e-5 where that ulp is finer, and P and dS rounded to
bf16 once are shown to miss it.
"""

import ctypes
import importlib
import types

import numpy as np
import pytest
import torch

from daliid_tpu_torch.ops.flash_attention import attention_backward, flash_attention

# the module (the package's ``ops.flash_attention`` attribute is the function)
fa = importlib.import_module("daliid_tpu_torch.ops.flash_attention")

LOG2E = 1.4426950408889634


def _tensors(shape, n=4, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
            for _ in range(n)]


def _bias(g, h, n, seed=1):
    rng = np.random.default_rng(seed)
    bias = rng.normal(size=(g, h, n, n)).astype(np.float32)
    if g > 1:
        bias += (rng.random((g, 1, n, n)) < 0.5) * np.float32(-100.0)
    return torch.from_numpy(bias)


def _autograd(q, k, v, g, bias=None):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    if bias is not None:
        bias = bias.clone().requires_grad_()
    flash_attention(q, k, v, bias).backward(g)
    return [t.grad for t in (q, k, v, bias) if t is not None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("biased", [False, True])
def test_cpu_backward_is_the_plain_version_and_launches_nothing(dtype, biased):
    shape = (6, 17, 2, 32)
    q, k, v, g = _tensors(shape, dtype=dtype)
    bias = _bias(3, 2, 17) if biased else None
    counts = (flash_attention.grad_launches, flash_attention.bias_grad_launches)
    got = _autograd(q, k, v, g, bias)
    want = attention_backward(q, k, v, g, bias)
    assert len(got) == len(want) == (4 if biased else 3)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)
    assert (flash_attention.grad_launches, flash_attention.bias_grad_launches) == counts


@pytest.mark.parametrize("biased", [False, True])
def test_backward_off_the_cpu_launches_or_raises(biased):
    """A device without kernels raises (no plain fallback); with nothing to
    attend there is nothing to launch."""
    q, k, v, g = (t.to("meta") for t in _tensors((2, 5, 2, 32), dtype=torch.bfloat16))
    bias = _bias(1, 2, 5).to("meta") if biased else None
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        fa._backward_bias(q, k, v, g, bias) if biased else fa._backward(q, k, v, g)
    empty = [t[:0] for t in (q, k, v, g)]
    grads = fa._backward_bias(*empty, bias) if biased else fa._backward(*empty)
    assert [tuple(t.shape) for t in grads[:3]] == [(0, 5, 2, 32)] * 3
    assert not biased or grads[3].shape == bias.shape


def test_backward_checks_its_inputs():
    q, k, v, g = _tensors((4, 5, 2, 32))
    with pytest.raises(ValueError, match="output's gradient"):
        fa._backward(q, k, v, g[:, :4])
    with pytest.raises(ValueError, match="output's gradient"):
        fa._backward(q, k, v, g.bfloat16())
    with pytest.raises(ValueError, match="one shape"):
        fa._backward(q, k[:, :4], v, g)
    with pytest.raises(ValueError, match="G dividing"):
        fa._backward_bias(q, k, v, g, _bias(3, 2, 5))
    with pytest.raises(ValueError, match="G dividing"):
        fa._backward_bias(q, k, v, g, _bias(2, 2, 4))


def test_kernel_reads_decides_the_copies_of_the_output_gradient():
    """dO goes to the kernel as it is where its rows are 16-byte copies, as
    q, k and v do; otherwise the wrapper copies it."""
    from daliid_tpu_torch.ops.flash_attention import _kernel_reads

    g = torch.zeros((2, 211, 12, 64), dtype=torch.bfloat16)
    assert _kernel_reads(g)
    assert not _kernel_reads(torch.zeros((2, 211, 12, 65), dtype=torch.bfloat16)[..., :64])
    assert not _kernel_reads(g.transpose(-1, -2).contiguous().transpose(-1, -2))


class _FakeEntry:
    """A C entry point that records its arguments and, for the biased
    backward, fills the dbias partials with known values."""

    def __init__(self):
        self.calls = []
        self.argtypes = None
        self.partial = None

    def __call__(self, *args):
        self.calls.append(args)
        if len(args) == len(fa.BIAS_GRAD_ARGTYPES):
            _, n, h, _, groups, chunks = args[17:23]
            self.partial = torch.arange(chunks * groups * h * n * n, dtype=torch.float32)
            ctypes.memmove(args[27], self.partial.data_ptr(), 4 * self.partial.numel())
        return 0


@pytest.fixture
def fake_entry(monkeypatch):
    entry = _FakeEntry()
    monkeypatch.setattr(fa, "_grad_fn", lambda name, argtypes: entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=4242))
    return entry


def _views_and_strides(shape, dtype):
    q, k, v, g = _tensors(shape, dtype=dtype)
    views = (q, k[:, :, :], v.transpose(1, 2).contiguous().transpose(1, 2), g)
    return views, [s for t in views for s in t.stride()[:3]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unbiased_launch_arguments_and_one_count_a_call(fake_entry, dtype):
    b, n, h, d = shape = (3, 7, 2, 64)
    views, strides = _views_and_strides(shape, dtype)
    grads = tuple(torch.empty(shape, dtype=dtype) for _ in range(3))
    before = flash_attention.grad_launches
    for calls in (1, 2):
        fa._launch_grad(views, strides, grads)
        assert flash_attention.grad_launches - before == calls
    args = fake_entry.calls[-1]
    assert len(args) == len(fa.GRAD_ARGTYPES)
    assert list(args[:4]) == [t.data_ptr() for t in views]
    assert list(args[4:16]) == strides and strides[6:9] == [n * h * d, d, n * d]
    assert args[16:20] == (b, n, h, d)
    assert args[20] == pytest.approx(d ** -0.5) and args[21] == int(dtype == torch.bfloat16)
    assert list(args[22:25]) == [t.data_ptr() for t in grads]
    assert args[25] != args[26] and args[27] == 4242


def test_biased_launch_arguments_count_and_dbias_sum(fake_entry):
    b, n, h, d = shape = (12, 9, 2, 32)
    groups = 3
    views, strides = _views_and_strides(shape, torch.bfloat16)
    bias = _bias(groups, h, n)
    grads = tuple(torch.empty(shape, dtype=torch.bfloat16) for _ in range(3))
    before = flash_attention.bias_grad_launches
    dbias = fa._launch_bias_grad(views, strides, bias, grads)
    assert flash_attention.bias_grad_launches - before == 1
    args = fake_entry.calls[-1]
    assert len(args) == len(fa.BIAS_GRAD_ARGTYPES)
    assert list(args[:4]) == [t.data_ptr() for t in views] and list(args[4:16]) == strides
    chunks = fa.bias_grad_chunks(b // groups, groups * h)
    assert args[17:23] == (b, n, h, d, groups, chunks)
    assert args[23] == pytest.approx(d ** -0.5) and args[28] == 4242
    assert list(args[24:27]) == [t.data_ptr() for t in grads]
    want = fake_entry.partial.view(chunks, groups, h, n, n).sum(dim=0)
    assert dbias.shape == bias.shape and dbias.dtype == torch.float32
    assert torch.equal(dbias, want)


@pytest.mark.parametrize("images,windows,heads", [(384, 70, 4), (384, 21, 8), (384, 8, 16),
                                                  (384, 2, 32), (26880, 1, 4), (3, 1, 2),
                                                  (1, 5, 3), (1000, 1, 1)])
def test_bias_grad_chunks_cover_every_image_once(images, windows, heads):
    """Each (window, head) pair's images cut into chunks of ceil(images /
    chunks), none empty, about BIAS_GRAD_BLOCKS blocks in all."""
    for groups in {1, windows}:
        pairs = groups * heads
        chunks = fa.bias_grad_chunks(images, pairs)
        per = -(-images // chunks)
        assert 1 <= chunks <= images
        assert (chunks - 1) * per < images <= chunks * per
        assert pairs * chunks <= max(pairs, 2 * fa.BIAS_GRAD_BLOCKS)


# ---- the kernels' bf16 arithmetic, emulated in plain torch ----

def _split(x, split=True):
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def _grad_bf16_arithmetic(q, k, v, g, bias=None, split=True):
    """The kernels' bf16 design on (B, N, H, D) bf16 tensors in f32 torch
    (see the module note) → (dq, dk, dv) in bf16, and with a bias dbias."""
    b, n, h, d = q.shape
    qf, kf, vf, gf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, g))
    s = (qf @ kf.transpose(-1, -2)) * torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
    if bias is not None:
        groups = bias.shape[0]
        s = (s.view(b // groups, groups, h, n, n) + bias * LOG2E).view(b, h, n, n)
    m = s.amax(-1, keepdim=True)
    e = torch.exp2(s - m)
    l = e.sum(-1, keepdim=True)
    dp = gf @ vf.transpose(-1, -2)
    if bias is None:  # k4_grad_dq's row statistics, then P from the log-sum-exp
        delta = (e * dp).sum(-1, keepdim=True) / l
        p = torch.exp2(s - (m + torch.log2(l)))
    else:  # wattn_grad_mma's one softmax
        p = e * (1.0 / l)
        delta = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = (_split(ds, split) @ kf) * d ** -0.5
    dk = (_split(ds, split).transpose(-1, -2) @ qf) * d ** -0.5
    dv = _split(p, split).transpose(-1, -2) @ gf
    grads = [t.permute(0, 2, 1, 3).bfloat16().contiguous() for t in (dq, dk, dv)]
    if bias is not None:
        grads.append(ds.view(-1, *bias.shape).sum(dim=0))
    return grads


def _beyond_one_ulp(got, want) -> int:
    got, want = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    tol = torch.clamp(torch.ldexp(torch.ones_like(got), e - 8), min=2e-5)
    return int(((got - want).abs() > tol).sum())


CASES = [((2, 211, 3, 64), None), ((4, 53, 3, 64), None), ((2, 129, 2, 96), None),
         ((3, 1, 2, 32), None), ((14, 49, 4, 32), 1), ((14, 49, 4, 32), 7)]


@pytest.mark.parametrize("shape,groups", CASES)
def test_bf16_backward_arithmetic_within_one_ulp(shape, groups):
    q, k, v, g = _tensors(shape, dtype=torch.bfloat16, seed=shape[1])
    bias = None if groups is None else _bias(groups, shape[2], shape[1], seed=groups)
    got = _grad_bf16_arithmetic(q, k, v, g, bias)
    want = attention_backward(q, k, v, g, bias)
    for a, w in zip(got[:3], want[:3]):
        assert a.dtype == w.dtype == torch.bfloat16
        assert _beyond_one_ulp(a, w) == 0
    if bias is not None:  # dbias in f32, the same sums in another order
        assert float((got[3] - want[3]).abs().max()) <= 1e-5 * float(want[3].abs().max())


@pytest.mark.parametrize("shape,groups", [((2, 211, 3, 64), None), ((14, 49, 4, 32), 7)])
def test_one_bf16_rounding_of_p_and_ds_breaks_the_check(shape, groups):
    """P and dS rounded to bf16 once (2^-9) miss the check: the split is
    needed."""
    q, k, v, g = _tensors(shape, dtype=torch.bfloat16, seed=shape[1])
    bias = None if groups is None else _bias(groups, shape[2], shape[1], seed=groups)
    got = _grad_bf16_arithmetic(q, k, v, g, bias, split=False)
    want = attention_backward(q, k, v, g, bias)
    assert all(_beyond_one_ulp(a, w) > 100 for a, w in zip(got[:3], want[:3]))
