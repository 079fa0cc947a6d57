"""The yardstick of the per-layer metrics: published peaks, the operations and
bytes of the port's kernels K1-K4 from the shapes a cell defines, and the
model FLOPs of the ``mfu`` metrics.

The kernel counts are the arithmetic of ``chip_smoke.py`` (``_timing`` and
the K1-K4 timing phases), kept here so that a later change to the program
is read against the same bound: each input byte read once and each output
byte written once, the operations the algorithm needs for these inputs.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def least_seconds(flops: float, nbytes: float, op_type: str) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS[op_type])


def k1_augment(b: int, h: int, w: int, out_bytes: int = 2) -> tuple:
    """K1 over a (B, H, W, 3) uint8 batch with the (B, 16) f32 table → (ops,
    bytes, op type): about 30 f32 operations a pixel."""
    return 30 * b * h * w, b * h * w * 3 * (1 + out_bytes) + b * 16 * 4, "f32"


def k2_rank_counts(q: int, g: int, p: int, valid: int) -> tuple:
    """K2 over a (Q, G) f32 distance matrix with P positive slots a query, of
    which ``valid`` hold a counted positive: one compare per gallery entry
    and valid positive."""
    return g * valid, 4 * q * g + 8 * q * p + 8 * (q + g) + 4 * q * p, "f32"


def k3_sq8(q: int, rows: int, d: int, k: int) -> tuple:
    """K3's SQ8 search of Q int8 probes over ``rows`` int8 rows of width D
    with their f32 scales, top-k (value, index) out."""
    return 2 * q * rows * d, rows * d + 4 * rows + q * d + 8 * q * k, "int8"


def k4_attention(b: int, n: int, h: int, d: int, elem_bytes: int = 2) -> tuple:
    """K4's forward over (B, N, H, D): q, k, v read and the output written
    once; QK^T and PV."""
    return 4 * b * h * n * n * d, 4 * b * n * h * d * elem_bytes, "bf16"


def kernel_roofline(launches: list, device_s: float):
    """Σ least time of ``launches`` [(ops, bytes, type)] over their device
    seconds, in %; None where there is nothing to read."""
    if not launches or device_s <= 0.0:
        return None
    return 100.0 * sum(least_seconds(*c) for c in launches) / device_s
