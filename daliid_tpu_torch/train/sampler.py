"""PK batch sampling with distortion-paired augmentation — fixed shapes.

Copy of ``daliid_tpu/train/sampler.py`` (``PKBatchSampler``, ``:53-144``):
for one seed it emits the same batches as the JAX sampler (numpy PCG64, the
same draws in the same order).

Re-implements the reference's ``samplePKBatches`` dataset
(``Person-ReID/train_encodersKIT.py:292-403``):

- an epoch iterates a shuffled set of pseudo-identities in groups of P
  (``DataLoader(batch_size=min(P, num_classes), shuffle=True,
  drop_last=True)``, ``train_encodersKIT.py:82-83``);
- each identity contributes K images sampled without replacement
  (``min(n, K)``, ``train_encodersKIT.py:330``);
- ``kind_of_transform == 0``: clean images only, distortion label 0
  (``train_encodersKIT.py:350-360``);
- ``kind_of_transform == 1``: every image is paired with its pre-rendered
  turbulence copy at a uniformly random strength 1-5, emitted adjacently
  with distortion labels ``[0, s]`` (``train_encodersKIT.py:365-394``); the
  copy's name follows ``dataset`` (default: the table's name), as
  :func:`~daliid_tpu_torch.data.turbulence.turbulence_path` reads it.

Departure kept from the JAX package: the reference tolerates ragged
batches (classes with < K images yield fewer samples); here every batch is
exactly ``P*K`` (or ``P*K*2`` when paired) slots with a validity mask —
padding slots repeat the class's first image and are masked out of every
loss (the loss library accepts ``sample_mask``).

The sampler is pure-host and index-based: it emits paths + labels +
distortion levels; decode/augment happen downstream.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np

from daliid_tpu_torch.data.registry import ReidTable
from daliid_tpu_torch.data.turbulence import turbulence_path


@dataclasses.dataclass
class PKBatch:
    """One fixed-shape training batch (host side, pre-decode)."""

    paths: List[str]            # B image paths (clean or turbulence copies)
    labels: np.ndarray          # (B,) int32 — dense class indices
    distortions: np.ndarray     # (B,) int32 in [0, 5]
    mask: np.ndarray            # (B,) bool — False on padding slots
    pids: np.ndarray            # (B,) original identity labels (diagnostics)
    camids: np.ndarray          # (B,) camera ids (SIE conditioning)

    def __len__(self) -> int:
        return len(self.paths)


class PKBatchSampler:
    """Iterable over an epoch of PK batches."""

    def __init__(
        self,
        table: ReidTable,
        labels: np.ndarray,            # pseudo-labels, one per table row
        P: int = 16,
        K: int = 12,
        kind_of_transform: int = 1,
        turbulence_dir: str | None = None,
        dataset: str | None = None,
        turbulence_strengths=(1, 2, 3, 4, 5),
        seed: int = 12,
    ):
        self.table = table
        self.labels = np.asarray(labels)
        self.label_set = np.unique(self.labels)
        # dense class index per row (loss centers are ordered by label)
        self.label_to_class = {l: i for i, l in enumerate(self.label_set)}
        self.P = min(P, len(self.label_set))
        self.K = K
        self.kind_of_transform = kind_of_transform
        self.turbulence_dir = turbulence_dir
        # names the turbulence copies (MSMT17's are pid-prefixed)
        self.dataset = dataset or table.name
        self.strengths = tuple(turbulence_strengths)
        self._rng = np.random.default_rng(seed)
        if kind_of_transform == 1 and not turbulence_dir:
            raise ValueError("kind_of_transform=1 requires turbulence_dir")
        # per-class row indices
        self._class_rows = {l: np.where(self.labels == l)[0] for l in self.label_set}

    @property
    def num_classes(self) -> int:
        return len(self.label_set)

    @property
    def batch_size(self) -> int:
        per = 2 if self.kind_of_transform == 1 else 1
        return self.P * self.K * per

    def batches_per_epoch(self) -> int:
        return len(self.label_set) // self.P  # drop_last=True

    def epoch(self) -> Iterator[PKBatch]:
        order = self._rng.permutation(self.label_set)
        for b in range(self.batches_per_epoch()):
            yield self._make_batch(order[b * self.P : (b + 1) * self.P])

    def _make_batch(self, batch_labels) -> PKBatch:
        paths: List[str] = []
        labels: List[int] = []
        distortions: List[int] = []
        mask: List[bool] = []
        pids: List[int] = []
        camids: List[int] = []
        for label in batch_labels:
            rows = self._class_rows[label]
            take = min(len(rows), self.K)
            chosen = self._rng.choice(len(rows), size=take, replace=False)
            # pad to K by repeating the first choice, masked out
            slot_rows = [rows[chosen[i % take]] for i in range(self.K)]
            slot_valid = [i < take for i in range(self.K)]
            for row, valid in zip(slot_rows, slot_valid):
                img_path = str(self.table.paths[row])
                cls = self.label_to_class[label]
                pid = int(self.table.pids[row])
                camid = int(self.table.camids[row])
                if self.kind_of_transform == 1:
                    s = int(self._rng.choice(self.strengths))
                    at_path = turbulence_path(img_path, self.turbulence_dir, s, self.dataset)
                    paths += [img_path, at_path]
                    labels += [cls, cls]
                    distortions += [0, s]
                    mask += [valid, valid]
                    pids += [pid, pid]
                    camids += [camid, camid]
                else:
                    paths.append(img_path)
                    labels.append(cls)
                    distortions.append(0)
                    mask.append(valid)
                    pids.append(pid)
                    camids.append(camid)
        return PKBatch(
            paths=paths,
            labels=np.asarray(labels, np.int32),
            distortions=np.asarray(distortions, np.int32),
            mask=np.asarray(mask, bool),
            pids=np.asarray(pids, np.int64),
            camids=np.asarray(camids, np.int32),
        )
