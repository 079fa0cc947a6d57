"""Rank helpers: the port's stand-in for the JAX package's ``data`` mesh.

Port of ``daliid_tpu/parallel/mesh.py`` (``:26-90``). Where the JAX package
shards axis 0 over a ``data`` mesh axis (``P("data")``) and brings results
back with ``fetch_global``, each rank here holds a contiguous block of the
rows: :func:`row_range` and :func:`local_rows` give it, :func:`gather_rows`
is the all-gather back to the full array on every rank, and
:func:`all_reduce_` merges sums. Without a process group every function is
the identity on one process.

:func:`active` is true once a process group exists, also one of a single
rank: the gang's code path (global batch statistics, summed gradients,
the checkpoint barrier) then runs as it would with more ranks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def active() -> bool:
    """True once this process has joined a gang."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def pad_to_multiple(array, multiple: int, axis: int = 0):
    """Pad ``axis`` with zeros up to a multiple of ``multiple`` (numpy or
    torch) → (padded, original length)."""
    n = array.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return array, n
    shape = list(array.shape)
    shape[axis] = pad
    if torch.is_tensor(array):
        return torch.cat([array, array.new_zeros(shape)], dim=axis), n
    return np.concatenate([array, np.zeros(shape, array.dtype)], axis=axis), n


def row_range(n: int, r: int | None = None, w: int | None = None) -> tuple[int, int]:
    """[start, stop) of rank ``r``'s block of ``n`` rows: blocks of
    ``ceil(n / world)`` rows in rank order, the last ones short or empty."""
    r = rank() if r is None else r
    w = world() if w is None else w
    block = -(-n // w)
    start = min(r * block, n)
    return start, min(start + block, n)


def local_rows(global_array):
    """This rank's block of axis 0 of an array every rank holds whole."""
    start, stop = row_range(global_array.shape[0])
    return global_array[start:stop]


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a collective on ``t`` runs: gloo gathers from host memory."""
    if t.device.type == "cuda" and dist.get_backend() != "nccl":
        return torch.device("cpu")
    return t.device


def all_reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """In-place SUM / MAX over ranks; the identity without a gang. Gloo and
    NCCL both take CUDA tensors here; a host tensor in an NCCL gang goes
    through the card."""
    if not active():
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if t.device.type == "cpu" and dist.get_backend() == "nccl":
        on_card = t.to(torch.device("cuda", torch.cuda.current_device()))
        dist.all_reduce(on_card, op=red)
        t.copy_(on_card.cpu())
    else:
        dist.all_reduce(t, op=red)
    return t


class _AllReduceSum(torch.autograd.Function):
    """SUM over ranks whose backward is the SUM of the gradients: each
    rank's input feeds every rank's output (``torch.distributed.nn``'s
    ``all_reduce``, which recent torch deprecates, computes the same)."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone())


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Differentiable SUM over ranks (a new tensor); the identity without a
    gang."""
    return _AllReduceSum.apply(t) if active() else t


def barrier() -> None:
    """Wait for every rank: a one-element all-reduce on the device the
    collectives use, synchronized."""
    if active():
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
        flag = torch.zeros(1, device=dev)
        dist.all_reduce(flag)
        flag.cpu()


def _all_gather(local: torch.Tensor, block: int) -> list[torch.Tensor]:
    """Every rank's ``local`` padded to ``block`` rows, in rank order, on
    ``local``'s device."""
    comm = _comm_device(local)
    x = local.detach().to(comm)
    if x.shape[0] < block:
        x = torch.cat([x, x.new_zeros((block - x.shape[0], *x.shape[1:]))])
    parts = [torch.empty_like(x) for _ in range(world())]
    dist.all_gather(parts, x.contiguous())
    return [p.to(local.device) for p in parts]


class _GatherRows(torch.autograd.Function):
    """All-gather of row blocks whose backward keeps this rank's rows.

    Every rank computes the same function of the gathered rows (the
    replicated loss), so the gradient with respect to this rank's rows is
    its slice of the gathered gradient; the parameters' gradients are then
    summed over the ranks."""

    @staticmethod
    def forward(ctx, local, sizes):
        ctx.span = (sum(sizes[:rank()]), sum(sizes[:rank() + 1]))
        parts = _all_gather(local, max(sizes))
        return torch.cat([p[:s] for p, s in zip(parts, sizes)])

    @staticmethod
    def backward(ctx, grad):
        start, stop = ctx.span
        return grad[start:stop], None


def gather_rows(local: torch.Tensor, sizes: list[int]) -> torch.Tensor:
    """Every rank's rows, concatenated in rank order, on every rank
    (``fetch_global``'s all-gather); ``sizes`` is each rank's row count.
    Differentiable: see :class:`_GatherRows`. The identity without a
    gang."""
    if not active():
        return local
    return _GatherRows.apply(local, list(sizes))
