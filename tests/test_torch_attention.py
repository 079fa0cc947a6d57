"""Kernel K4's plain version and gradient in the PyTorch port against the
JAX package's ``flash_attention`` in interpret mode, on the CPU.

On CPU tensors ``daliid_tpu_torch.ops.flash_attention.flash_attention`` is
the plain version behind the autograd Function whose backward is the JAX
VJP's ``_bwd``; the JAX side runs the Pallas kernel with ``interpret=True``
and its custom VJP. Inputs are (B, N, H, D) arrays made with numpy.

Tolerances: f32 outputs within atol 2e-5 (the bound ``tests/test_ops.py``
holds the Pallas kernel to; measured 2.4e-7); bf16 outputs within one bf16
ulp of the larger magnitude (both upcast the same bf16 inputs, compute in
f32 and round once, so only a rounding boundary can part them); gradients
within atol 3e-5 (the backward recomputes P in f32 on both sides).

The CUDA kernel's bf16 arithmetic (tensor-core products, P split in two
bf16 parts) is emulated in plain torch and held to ``chip_smoke.py``'s bf16
check: one bf16 ulp of the larger magnitude, or 2e-5 where that ulp is
finer; P rounded to bf16 once is shown to miss it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daliid_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from daliid_tpu_torch.ops.flash_attention import attention_plain, flash_attention


def _qkv(n, d, b=2, h=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, h, d)).astype(np.float32) for _ in range(3)]


def _jax(q, k, v):
    return np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          interpret=True))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [7, 16, 53, 129])
def test_plain_attention_matches_the_interpret_kernel(n, d):
    q, k, v = _qkv(n, d, seed=n + d)
    got = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert got.shape == (2, n, 2, d) and got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v), rtol=0, atol=2e-5)


@pytest.mark.parametrize("n", [7, 53])
def test_plain_attention_in_bf16_matches_the_interpret_kernel(n):
    q, k, v = _qkv(n, 64, seed=3)
    got = flash_attention(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)))
    want = jax_flash_attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                               interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("n,d", [(16, 32), (53, 64)])
def test_gradient_matches_jax_grad_of_the_interpret_kernel(n, d):
    q, k, v = _qkv(n, d, seed=7)
    g = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        return jnp.sum(jax_flash_attention(q_, k_, v_, interpret=True) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    (flash_attention(tq, tk, tv) * torch.from_numpy(g)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=3e-5)


def test_kernel_reads_strided_views_of_a_fused_projection():
    """q, k and v as the column blocks of one (B, N, 3C) tensor, as the ViT's
    qkv projection gives them, equal the contiguous copies."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.normal(size=(2, 11, 3 * 2 * 32)).astype(np.float32))
    q, k, v = (t.unflatten(-1, (2, 32)) for t in qkv.split(64, dim=-1))
    assert not q.is_contiguous()
    got = flash_attention(q, k, v)
    assert torch.equal(got, attention_plain(q.contiguous(), k.contiguous(), v.contiguous()))


def test_wrapper_checks_its_inputs_and_counts_only_kernel_launches():
    flash_attention.launches = 0
    q = torch.zeros(2, 5, 2, 32)
    with pytest.raises(ValueError, match="one shape"):
        flash_attention(q, q[:, :4], q)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q, q.double(), q)
    meta = q.to("meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        flash_attention(meta, meta, meta)
    empty = meta[:0]
    assert flash_attention(empty, empty, empty).shape == (0, 5, 2, 32)
    flash_attention(q, q, q)  # the plain version on the CPU
    assert flash_attention.launches == 0


# ---- the bf16 tensor-core kernel's arithmetic, emulated in plain torch ----

def _k4_bf16_arithmetic(q, k, v, split=True, tile=64):
    """K4's bf16 design on (B, N, H, D) bf16 tensors, in f32 torch: S = Q.K^T
    in f32 times scale·log2(e), an online softmax over 64-key tiles with
    exp2, P entering P.V as bf16(P) + bf16(P - bf16(P)) (or, with ``split``
    off, as bf16(P) alone), O times 1/l, one rounding to bf16."""
    b, n, h, d = q.shape
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    scale = torch.tensor(d ** -0.5 * 1.4426950408889634, dtype=torch.float32)
    m = torch.full((b, h, n, 1), float("-inf"))
    l = torch.zeros((b, h, n, 1))
    o = torch.zeros((b, h, n, d))
    for k0 in range(0, n, tile):
        s = (qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        o = o * alpha + p_hi @ vf[:, :, k0:k0 + tile]
        if split:
            o = o + (p - p_hi).bfloat16().float() @ vf[:, :, k0:k0 + tile]
        m = m_new
    return (o * (1.0 / l)).permute(0, 2, 1, 3).bfloat16().contiguous()


def _beyond_the_bf16_check(got, want) -> int:
    """Elements where ``got`` and ``want`` differ by more than chip_smoke's
    K4 bf16 tolerance: one bf16 ulp of the larger magnitude, or 2e-5 where
    that ulp is finer (near zero)."""
    got, want = got.float().numpy(), want.float().numpy()
    tol = np.maximum(_bf16_ulp(np.maximum(np.abs(got), np.abs(want))), 2e-5)
    return int((np.abs(got - want) > tol).sum())


@pytest.mark.parametrize("n", [53, 211])
def test_bf16_tensor_core_arithmetic_within_one_ulp(n):
    """The split-P design stays within chip_smoke's bf16 check of the plain
    version and of the JAX interpret kernel, at the JPM's token counts."""
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _qkv(n, 64, b=2, h=3, seed=n))
    got = _k4_bf16_arithmetic(q, k, v)
    want_jax = jax_flash_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                     for t in (q, k, v)), interpret=True)
    want_jax = torch.from_numpy(np.array(want_jax.astype(jnp.float32)))
    assert _beyond_the_bf16_check(got, attention_plain(q, k, v)) == 0
    assert _beyond_the_bf16_check(got, want_jax) == 0


def test_one_bf16_rounding_of_p_breaks_the_check():
    """P rounded to bf16 once (2^-9) is not within the check: the split is
    needed."""
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _qkv(211, 64, b=2, h=3, seed=211))
    assert _beyond_the_bf16_check(_k4_bf16_arithmetic(q, k, v, split=False),
                                  attention_plain(q, k, v)) > 100


def test_kernel_reads_the_vit_views_and_copies_misaligned_ones():
    """The bf16 kernel copies rows with 16-byte cp.async: the qkv projection's
    column blocks qualify as they are; a view shifted by one element, or
    with a non-unit D stride, is copied first."""
    from daliid_tpu_torch.ops.flash_attention import _kernel_reads

    h, d = 12, 64
    qkv = torch.zeros((2, 211, 3 * h * d), dtype=torch.bfloat16)
    assert all(_kernel_reads(t.unflatten(-1, (h, d))) for t in qkv.split(h * d, dim=-1))
    assert not _kernel_reads(qkv[..., 1:1 + h * d].unflatten(-1, (h, d)))
    assert not _kernel_reads(qkv[..., :h * d].unflatten(-1, (d, h)).transpose(-1, -2))
    assert _kernel_reads(qkv.float()[..., 1:1 + h * d].unflatten(-1, (h, d)))  # f32: any
