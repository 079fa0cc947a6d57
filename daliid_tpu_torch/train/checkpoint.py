"""Checkpoints of the full training state with ``torch.save``.

Counterpart of ``daliid_tpu/train/checkpoint.py``, whose orbax manager the
port replaces. A checkpoint ``<directory>/<epoch>.pt`` holds the online and
momentum ``state_dict`` (the reference's torch keys), the optimizer state,
the epoch, the host RNG state (:meth:`Trainer.rng_state`) and the eval
metrics it was saved with. :class:`CheckpointManager` keeps either the best
``max_to_keep`` steps by ``rank1`` (the best-metric manager of
``cli/train.py:312``) or the newest ones (the crash-resume ``latest/``
manager, ``:316-319``). :func:`save_weights` writes the weights-only
``model_{online,momentum}_<name>_<version>.pt`` files that
``models/torch_port.load_state`` reads. :func:`save_variables` and
:func:`load_variables` (JAX ``:189-210``) write and read the JAX package's
weights-only ``.npz`` of flattened paths, which ``cli/export.py`` makes
from the port's weights.

Files are written to a temporary name and renamed into place, so a crash
never leaves a half-written checkpoint under its final name.

In a gang (:mod:`daliid_tpu_torch.parallel`) every save begins with a
barrier over the ranks, then rank 0 alone writes; every rank keeps the same
index in memory and restores from the same file. The barrier stands in for
orbax's (``daliid_tpu/train/checkpoint.py:64-103``): a survivor whose gang
lost a rank blocks there, so it never commits an epoch the gang did not
finish. :func:`save_weights` writes on rank 0 only.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from daliid_tpu_torch.parallel.mesh import barrier, rank

_INDEX = "index.json"


def _rng_to_tensors(rng: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    # uint64 words travel as their int64 bit patterns (torch.load's
    # weights_only reader takes plain tensors)
    out = {}
    for k, v in rng.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(a.view(np.int64).copy() if a.dtype == np.uint64 else a.copy())
    return out


def _rng_from_tensors(rng: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: (v.numpy().view(np.uint64) if v.dtype == torch.int64 else v.numpy())
            for k, v in rng.items()}


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Numbered epochs under one directory, retained best-first by
    ``rank1`` (``track_best=True``) or newest-first."""

    def __init__(self, directory: str, max_to_keep: int = 3, track_best: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.track_best = track_best
        if rank() == 0:
            os.makedirs(self.directory, exist_ok=True)
        index = os.path.join(self.directory, _INDEX)
        self._metrics: Dict[int, Dict[str, float]] = {}
        if os.path.exists(index):
            with open(index) as f:
                self._metrics = {int(k): v for k, v in json.load(f).items()}

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{epoch}.pt")

    def save(self, epoch: int, state: dict, metrics: Dict[str, float] | None = None,
             rng: Dict[str, np.ndarray] | None = None) -> None:
        """``state`` is :meth:`Trainer.state_dict`; ``rng`` its
        :meth:`~Trainer.rng_state` (a resumed run then replays the stream)."""
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        barrier()  # the whole gang reached this epoch's save
        writer = rank() == 0
        if writer:
            payload = {"state": state, "epoch": int(epoch), "metrics": metrics,
                       "rng": _rng_to_tensors(rng) if rng is not None else None}
            _atomic_save(payload, self._path(epoch))
        self._metrics[int(epoch)] = metrics
        if self.track_best:
            keep = sorted(self._metrics, key=lambda e: (self._metrics[e].get("rank1", 0.0), e),
                          reverse=True)[:self.max_to_keep]
        else:
            keep = sorted(self._metrics, reverse=True)[:self.max_to_keep]
        for e in set(self._metrics) - set(keep):
            if writer:
                os.remove(self._path(e))
            del self._metrics[e]
        if not writer:
            return
        tmp = os.path.join(self.directory, f"{_INDEX}.{os.getpid()}.tmp")
        with open(tmp, "w") as f:
            json.dump({str(k): v for k, v in self._metrics.items()}, f)
        os.replace(tmp, os.path.join(self.directory, _INDEX))

    def restore(self, epoch: int | None = None) -> Tuple[dict, int, dict | None]:
        """→ (state, epoch, rng or None); ``epoch=None`` takes the latest."""
        step = epoch if epoch is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        rng = payload["rng"]
        return (payload["state"], int(payload["epoch"]),
                _rng_from_tensors(rng) if rng is not None else None)

    def metrics(self, step: int) -> Dict[str, float]:
        return dict(self._metrics.get(int(step), {}))

    def latest_step(self):
        return max(self._metrics) if self._metrics else None

    def best_step(self):
        if not self._metrics:
            return None
        return max(self._metrics, key=lambda e: (self._metrics[e].get("rank1", 0.0), e))


def save_weights(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Weights-only export (the reference's ``torch.save(state_dict)``,
    ``mainKIT.py:169-170``), on the CPU; rank 0 of a gang writes."""
    if rank() == 0:
        _atomic_save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def _flat_paths(tree, prefix: tuple = ()):
    """(path, leaf) pairs of a nested dict, keys in sorted order at every
    level (the order of ``jax.tree_util.tree_flatten_with_path``)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _flat_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path of string keys."""
    return "".join(f"['{k}']" for k in path)


def save_variables(path: str, variables) -> None:
    """Weights-only export as the JAX package writes it (the analogue of
    ``torch.save(state_dict)``, ``mainKIT.py:169-170``): an ``.npz`` whose
    keys are the ``keystr`` paths of the nested dict ``variables``, e.g.
    ``['params']['layer1_0']['conv1']['kernel']``."""
    np.savez(path, **{_keystr(k): np.asarray(v) for k, v in _flat_paths(variables)})


def load_variables(path: str, template) -> Any:
    """Restore a weights-only ``.npz`` into the structure of the nested dict
    ``template``: every leaf of the template must be in the file at its
    shape (``KeyError`` / ``ValueError`` in the JAX package's words); keys
    the template lacks are ignored."""
    out: Dict[str, Any] = {}
    with np.load(path) as data:
        for keys, v in _flat_paths(template):
            key = _keystr(keys)
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            if arr.shape != np.shape(v):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {np.shape(v)}")
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = arr
    return out
