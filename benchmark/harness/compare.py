"""The numbers that decide ``correct``, each worked out the same way for the
program and for the control.

Norms are compared leaf by leaf as the gap between the two sides' norms,
over the reference's norm of that leaf or of the median leaf, whichever is
larger (some gradients are all but zero). The number is the median leaf's
gap; the worst leaves are printed beside it. The worst leaf is not steady
from seed to seed: at initialization ResNet-50's early batch-norm leaves
take gradients that bfloat16 moves by a third, and in the transformer the
key part of each ``qkv`` bias, whose gradient is nought under the softmax,
moves under Adam by round-off alone. The parameters' and the momentum
model's change leave out the leaves whose reference gradient is under a
thousandth of the median leaf's.
"""

from __future__ import annotations

import numpy as np


def leaf_gaps(prog: dict, ref: dict, keep=None) -> list:
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names]))
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names]


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The median leaf's gap."""
    return float(np.median(leaf_gaps(prog, ref, keep)))


def worst_leaves(prog: dict, ref: dict, keep=None, n: int = 3) -> list:
    """The ``n`` leaves with the largest gaps: (gap, name, program, reference)."""
    names = [k for k in ref if keep is None or k in keep]
    rows = zip(leaf_gaps(prog, ref, keep), names, (prog[k] for k in names),
               (ref[k] for k in names))
    return sorted(rows, reverse=True)[:n]


def moving_leaves(ref_grads: dict) -> set:
    med = float(np.median(list(ref_grads.values())))
    return {n for n, g in ref_grads.items() if g >= 1e-3 * med}


def row_gaps(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Each row's ``||prog - ref|| / ||ref||``."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(prog - ref, axis=1) / np.maximum(np.linalg.norm(ref, axis=1), 1e-30)


def row_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """The worst row's gap."""
    return float(row_gaps(prog, ref).max())


def pset_gap(prog, ref) -> float:
    """Centers, proxies and proxy labels: the largest absolute difference,
    infinite where a label differs."""
    if not np.array_equal(np.asarray(prog[2]), np.asarray(ref[2])):
        return float("inf")
    return float(max(np.abs(np.asarray(prog[0]) - ref[0]).max(),
                     np.abs(np.asarray(prog[1]) - ref[1]).max()))


def train_numbers(run, prog: dict, ref: dict) -> None:
    """Step losses, K1's batch (against the reference's augmentation of the
    program's decoded bytes), the first gradient, and the parameters' and
    the momentum model's change after the checked steps."""
    run.check("aug_gap", float((prog["aug"].float() - ref["aug"]).abs().max()))
    run.check("loss_gap", max(abs(a - b) / max(abs(b), 1e-30)
                              for a, b in zip(prog["losses"], ref["losses"])))
    keep = moving_leaves(ref["grads"])
    for name, k in (("grads", None), ("updates", keep), ("ema", keep)):
        run.note(f"worst {name}: " + "; ".join(
            f"{n} gap {g:.4g} program {p:.4g} reference {r:.4g} (gradient {ref['grads'][n]:.4g})"
            for g, n, p, r in worst_leaves(prog[name], ref[name], k)))
    run.check("grad_gap", leaf_gap(prog["grads"], ref["grads"]))
    run.check("update_gap", leaf_gap(prog["updates"], ref["updates"], keep))
    run.check("ema_gap", leaf_gap(prog["ema"], ref["ema"], keep))
