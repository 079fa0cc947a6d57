"""The operations and bytes of K4's backward kernels (``csrc/attention_grad.cu``
through ``ops/flash_attention.py``'s autograd Functions), and their share of
their roofline in a training window.

A backward call over (B, N, H, D) reads q, k, v and dO once and writes dq,
dk and dv once, in bf16; its products are the algorithm's five, each
2 N^2 D a row and head: S = Q K^T and dP = dO V^T recomputed, dV = P^T dO,
dQ = dS K and dK = dS^T Q (the kernels' recomputation and the bf16 split of
P and dS are work of the design, not of the gradient). The biased call, over
B images of ``windows`` windows with a (G, H, N, N) f32 bias, also reads the
bias and writes dbias once in f32. A call's least time counts once, however
many kernels it launches: the unbiased call launches two (``k4_grad_dq``,
``k4_grad_dkv``), the biased one (``wattn_grad_mma``; its partials' sum is a
PyTorch reduction, outside the stem). Mining runs no backward, so only the
window's optimizer steps count.
"""

from __future__ import annotations

from benchmark.roofline import kernel_roofline

K4_GRAD = ("k4_grad",)
WATTN_GRAD = ("wattn_grad",)
# kernels a call launches
K4_GRAD_KERNELS, WATTN_GRAD_KERNELS = 2, 1


def k4_grad(b: int, n: int, h: int, d: int, elem_bytes: int = 2) -> tuple:
    """(ops, bytes, op type) of one unbiased backward call."""
    return 10 * b * h * n * n * d, 7 * b * n * h * d * elem_bytes, "bf16"


def wattn_grad(b: int, windows: int, n: int, h: int, d: int, g: int, elem_bytes: int = 2,
               bias_bytes: int = 4) -> tuple:
    """(ops, bytes, op type) of one biased backward call over ``b`` images."""
    rows = b * windows
    return (10 * rows * h * n * n * d,
            7 * rows * n * h * d * elem_bytes + 2 * g * h * n * n * bias_bytes, "bf16")


def calls_share(run, names, per_call: int, calls: list):
    """Σ least time of ``calls`` over the device time of the traced kernels
    named ``names``, in %; None unless the trace holds exactly ``per_call``
    kernels for each call."""
    if run.tracer is None or not calls:
        return None
    n, seconds = run.tracer.device_seconds(names)
    if n == 0 or n != per_call * len(calls):
        return None
    return kernel_roofline(calls, seconds)


def _steps(run) -> list:
    """The batch of each optimizer step of the window."""
    return [run.counts["batch"]] * run.counts["steps"] if "batch" in run.counts else []


def k4_grad_train(run):
    """The unbiased backward's calls in the window's steps: one a forward
    launch, at the token counts the model's reference module's
    ``attention(cfg)`` gives."""
    per_forward = run.shapes.get("attention") or []
    calls = [k4_grad(b, n, h, d) for b in _steps(run) for count, n, h, d in per_forward
             for _ in range(count)]
    return calls_share(run, K4_GRAD, K4_GRAD_KERNELS, calls)


def wattn_grad_train(run):
    """The biased backward's calls in the window's steps, at the windows,
    tokens, heads and bias the reference module's ``window_attention(cfg)``
    gives."""
    from benchmark.harness.models import reference

    ref = reference(run.config)
    per_forward = ref.window_attention(run.config) if hasattr(ref, "window_attention") else []
    calls = [wattn_grad(b, windows, n, h, d, g) for b in _steps(run)
             for count, windows, n, h, d, g in per_forward for _ in range(count)]
    return calls_share(run, WATTN_GRAD, WATTN_GRAD_KERNELS, calls)
