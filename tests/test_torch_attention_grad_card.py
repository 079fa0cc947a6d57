"""K4's backward kernels (``csrc/attention_grad.cu``) against the plain
version, on the card.

Every test here is marked ``card`` and skips without a CUDA device (the
``card`` fixture decides, inside the test). The checks, their shapes and
their tolerances are ``chip_smoke.py``'s phase 9b (:func:`chip_smoke.check_unbiased`,
:func:`chip_smoke.check_biased`, :func:`chip_smoke.check_f32`): bf16 dq, dk
and dv within one bf16 ulp of :func:`attention_backward`'s, dbias within
2^-16 of the sum of |dS|, f32 within 3e-5, two calls bit-equal. The file
imports neither JAX nor the JAX package; on a machine with the card and no
JAX, run it without the tests' conftest::

    python -m pytest --noconftest -m card tests/test_torch_attention_grad_card.py
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke as smoke

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", smoke.GRAD_UNBIASED)
def test_unbiased_kernels_within_one_bf16_ulp_and_deterministic(card, shape):
    smoke.check_unbiased(torch, card, shape)


@pytest.mark.parametrize("stage,groups", smoke.GRAD_BIASED)
def test_biased_kernel_within_one_bf16_ulp_and_dbias_deterministic(card, stage, groups):
    smoke.check_biased(torch, card, stage, groups)


@pytest.mark.parametrize("shape", smoke.GRAD_F32)
def test_f32_kernels_against_the_plain_backward(card, shape):
    smoke.check_f32(torch, card, shape)


def test_a_view_the_kernel_cannot_read_is_copied_for_the_backward(card):
    """dO with a stride the 16-byte copies cannot take, and q shifted by one
    element, give the gradients of their contiguous copies."""
    gen = torch.Generator(device=card)
    gen.manual_seed(22)
    b, n, h, d = 4, 53, 3, 64
    wide = torch.randn((b, n, h, d + 1), generator=gen, device=card).to(torch.bfloat16)
    q = wide[..., 1:]
    k, v, g = (torch.randn((b, n, h, d), generator=gen, device=card).to(torch.bfloat16)
               for _ in range(3))
    g_odd = torch.randn((b, n, h, d + 1), generator=gen, device=card).to(torch.bfloat16)[..., :d]
    g_odd.copy_(g)
    got = smoke.grads(torch, q, k, v, g_odd)
    want = smoke.grads(torch, q.contiguous(), k, v, g)
    assert smoke.same_bits(torch, got, want)
