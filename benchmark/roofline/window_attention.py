"""The operations and bytes of the port's biased windowed-attention kernel
(``wattn_bias_mma``, ``ops/flash_attention.py`` with a ``bias``), and its
share of its roofline in a training window.

A launch over B images of nW windows of N tokens, H heads of D, with a
(G, H, N, N) f32 bias: QK^T and PV, 4 B nW H N^2 D operations in bf16; q,
k, v read and the output written once in bf16, the bias read once a launch.
"""

from __future__ import annotations

from benchmark.roofline.reading import kernel_pct

KERNEL = ("wattn_bias_mma",)


def wattn_bias(b: int, windows: int, n: int, h: int, d: int, g: int,
               elem_bytes: int = 2, bias_bytes: int = 4) -> tuple:
    """(ops, bytes, op type) of one launch over ``b`` images."""
    rows = b * windows
    return (4 * rows * h * n * n * d, 4 * rows * n * h * d * elem_bytes + g * h * n * n * bias_bytes,
            "bf16")


def launches(batches: list, per_forward: list) -> list:
    """The kernel's launches for forwards at the given batch sizes:
    ``per_forward`` [(launches, windows, tokens, heads, head dim, G)] a
    forward, as the model's reference module's ``window_attention(cfg)``
    gives them."""
    out = []
    for b in batches:
        for count, windows, n, h, d, g in per_forward:
            out += [wattn_bias(b, windows, n, h, d, g)] * count
    return out


def train_share(run):
    """Least time over device time of the kernel's launches in the steps
    (the step batch) and in mining (the extraction batch), in %; None
    unless the trace holds exactly those launches."""
    from benchmark.harness.models import reference

    ref = reference(run.config)
    per_forward = ref.window_attention(run.config) if hasattr(ref, "window_attention") else []
    if not per_forward or "batch" not in run.counts:
        return None
    batches = ([run.counts["batch"]] * run.counts["steps"]
               + [run.shapes["extract_batch"]] * run.counts["mining_batches"])
    return kernel_pct(run, KERNEL, launches(batches, per_forward))
