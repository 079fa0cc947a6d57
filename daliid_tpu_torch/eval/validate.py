"""Validators: query/gallery CMC + mAP on one device.

Port of ``daliid_tpu/eval/validate.py``: :class:`Validator` (``:38-221``)
with ``distance_matrix``, ``rank``, ``rank_features`` and
``multihead_distance_matrix`` (the replicated path) and ``validate``;
:class:`BriarValidator` (``:224-243``) and :func:`get_validator`
(``:246``), which differ from it only in the three protocol class
attributes. A multi-head model's tuple of head embeddings ranks by the
mean of the heads' distmats or their per-pair max-norm weighting
(``:168-188``), on the device. ``rerank=True`` applies k-reciprocal
re-ranking (``:82-106``, :func:`reranked_distance_matrix`) on the device.
:func:`msmt17_balanced_accuracy` (``:302-335``) and :class:`MSMT17Validator`
(``:252-299``) score a validation split by its nearest train-class center,
in numpy on the extracted features as the JAX function computes it.

``sharded`` (``:41-77``, ``:125-160``) routes :meth:`Validator.rank_features`
and :meth:`Validator.validate` through
:func:`~daliid_tpu_torch.metrics.ranking.evaluate_rank_sharded` (multi-head:
``evaluate_rank_sharded_multihead``): no (Q, G) matrix is built, each rank
of a gang ranks its block of the queries, and ``validate`` returns ``None``
for the distmat. ``None`` (the default) means on in a gang of more than one
rank; re-ranking needs the whole matrices and keeps the replicated path.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from daliid_tpu_torch.data.registry import ReidTable
from daliid_tpu_torch.device import resolve_device
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.eval.rerank import re_ranking
from daliid_tpu_torch.metrics.ranking import (
    cosine_distance_matrix,
    evaluate_rank,
    evaluate_rank_sharded,
    evaluate_rank_sharded_multihead,
)
from daliid_tpu_torch.parallel.mesh import world


class Validator:
    """Standard Market-protocol validation: extract → cosine distmat on the
    device → CMC/mAP through kernel K2."""

    # protocol knobs the BRIAR subclass overrides
    _count_all = False       # average over matched queries only (Market)
    _ignore_camera = False   # same-(pid, camid) junk filtering on
    _report_map = True       # BRIAR reports mAP as 0

    def __init__(self, img_size=(256, 128), batch_size: int = 512, device="cuda",
                 max_rank: int = 50, rerank: bool = False, sharded: bool | None = None):
        self.img_size = img_size
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.max_rank = max_rank
        self.rerank = rerank  # the commented path at validateModels.py:49-53
        self.sharded = sharded

    def sharded_active(self) -> bool:
        """Whether ranking takes the sharded path (``_sharded_active``)."""
        if self.rerank:
            return False
        return world() > 1 if self.sharded is None else bool(self.sharded)

    def distance_matrix(self, query_fvs, gallery_fvs) -> torch.Tensor:
        return cosine_distance_matrix(
            torch.as_tensor(np.asarray(query_fvs, np.float32), device=self.device),
            torch.as_tensor(np.asarray(gallery_fvs, np.float32), device=self.device),
        )

    def reranked_distance_matrix(self, query_fvs, gallery_fvs, verbose: bool = False):
        """The distmat with the validator's optional k-reciprocal
        re-ranking applied, on the device. As in the JAX package the
        query-query and gallery-gallery matrices are cosine distances, like
        the query-gallery one (the reference's commented code mixed in
        euclidean ones; on L2-normalized features the neighbour sets are
        the same, only the exp(-d) weights differ)."""
        distmat = self.distance_matrix(query_fvs, gallery_fvs)
        if not self.rerank:
            return distmat
        if verbose:
            print("Applying person re-ranking ...")
        return re_ranking(distmat, self.distance_matrix(query_fvs, query_fvs),
                          self.distance_matrix(gallery_fvs, gallery_fvs))

    def rank(self, distmat, queries: ReidTable, gallery: ReidTable):
        """→ (cmc curve of length max_rank — index with ``cmc[r-1]`` — , mAP)."""
        if not torch.is_tensor(distmat):
            distmat = torch.as_tensor(np.asarray(distmat, np.float32), device=self.device)
        cmc, mAP = evaluate_rank(
            distmat, queries.pids, gallery.pids, queries.camids, gallery.camids,
            max_rank=self.max_rank, count_all=self._count_all,
            ignore_camera=self._ignore_camera,
        )
        return cmc, (mAP if self._report_map else 0.0)

    def rank_features(self, q_fvs, g_fvs, queries: ReidTable, gallery: ReidTable,
                      head_weighting: str = "mean"):
        """CMC/mAP straight from raw embeddings: sharded (no distmat) when
        :meth:`sharded_active`, else the full distmat on the device; head
        tuples merge as :meth:`multihead_distance_matrix` does."""
        multi = isinstance(q_fvs, (tuple, list))
        if multi and self.rerank:
            raise ValueError("re-ranking a multi-head ensemble is undefined upstream "
                             "(evaluate.py never combines them); rerank per head instead")
        if self.sharded_active():
            kw = dict(max_rank=self.max_rank, count_all=self._count_all,
                      ignore_camera=self._ignore_camera, device=self.device)
            ids = (queries.pids, gallery.pids, queries.camids, gallery.camids)
            if multi:
                cmc, mAP = evaluate_rank_sharded_multihead(q_fvs, g_fvs, *ids,
                                                           head_weighting=head_weighting, **kw)
            else:
                cmc, mAP = evaluate_rank_sharded(q_fvs, g_fvs, *ids, **kw)
            return cmc, (mAP if self._report_map else 0.0)
        if multi:
            return self.rank(self.multihead_distance_matrix(q_fvs, g_fvs, head_weighting),
                             queries, gallery)
        return self.rank(self.reranked_distance_matrix(q_fvs, g_fvs), queries, gallery)

    def multihead_distance_matrix(self, q_heads, g_heads, head_weighting: str = "mean",
                                  distmats=None) -> torch.Tensor:
        """One distmat over head tuples: the mean of the heads' cosine
        distmats (``"mean"``), or each head's weighted per pair by the larger
        of the two raw-embedding norms (``"magnitude"``). ``distmats`` takes
        the heads' distmats when the caller has them already."""
        if head_weighting not in ("mean", "magnitude"):
            raise ValueError(f"head_weighting must be mean|magnitude, got {head_weighting!r}")
        if distmats is None:
            distmats = [self.distance_matrix(qh, gh) for qh, gh in zip(q_heads, g_heads)]
        if head_weighting == "mean":
            return torch.stack(distmats).mean(dim=0)
        weights = []
        for qh, gh in zip(q_heads, g_heads):
            qn, gn = (torch.linalg.vector_norm(
                torch.as_tensor(np.asarray(h, np.float32), device=self.device), dim=1)
                for h in (qh, gh))
            weights.append(torch.maximum(qn[:, None], gn[None, :]))
        return sum(w * d for w, d in zip(weights, distmats)) / sum(weights)

    def validate(self, queries: ReidTable, gallery: ReidTable, bundle_or_extractor,
                 verbose: bool = True):
        """→ (cmc, mAP, distmat as numpy, or None on the sharded path). Takes
        a ModelBundle or a reusable FeatureExtractor."""
        extractor = (
            bundle_or_extractor
            if isinstance(bundle_or_extractor, FeatureExtractor)
            else FeatureExtractor(bundle_or_extractor, img_size=self.img_size,
                                  batch_size=self.batch_size, device=self.device)
        )
        q_fvs = extractor.extract(queries, verbose=verbose)
        g_fvs = extractor.extract(gallery, verbose=verbose)
        if self.sharded_active():
            cmc, mAP = self.rank_features(q_fvs, g_fvs, queries, gallery)
            distmat = None
        else:
            if isinstance(q_fvs, tuple):
                distmat = self.multihead_distance_matrix(q_fvs, g_fvs)
            else:
                distmat = self.reranked_distance_matrix(q_fvs, g_fvs, verbose=verbose)
            cmc, mAP = self.rank(distmat, queries, gallery)
            distmat = distmat.cpu().numpy()
        if verbose:
            print(f"** Results ** mAP: {mAP:.2%}")
            for r in (1, 5, 10):
                print(f"Rank-{r:<3}: {cmc[r - 1]:.2%}")
        return cmc, mAP, distmat


class BriarValidator(Validator):
    """BRIAR-style CMC: no junk filtering, every query counted, mAP 0."""

    _count_all = True
    _ignore_camera = True
    _report_map = False

    def __init__(self, img_size=(256, 128), batch_size: int = 512, device="cuda",
                 max_rank: int = 20, rerank: bool = False, sharded: bool | None = None):
        super().__init__(img_size=img_size, batch_size=batch_size, device=device,
                         max_rank=max_rank, rerank=rerank, sharded=sharded)


def get_validator(dataset_name: str, **kw) -> Validator:
    if dataset_name == "BRIAR":
        return BriarValidator(**kw)
    return Validator(**kw)


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)


class MSMT17Validator:
    """Best balanced accuracy over training: each :meth:`validate` scores
    the online and the momentum model on the val split and, when the better
    of the two beats the best so far, saves both models' weights as
    ``model_{online,momentum}_bestACC_<model>_<version>.pt`` under
    ``save_dir``."""

    def __init__(self, train_table, val_table, img_size=(256, 128), batch_size: int = 512,
                 save_dir=None, model_name: str = "model", version: str = "v0"):
        self.train_table = train_table
        self.val_table = val_table
        self.img_size = img_size
        self.batch_size = batch_size
        self.save_dir = save_dir
        self.model_name = model_name
        self.version = version
        self.best_accuracy = 0.0
        self.best_iter = 0

    def validate(self, pipeline_iter, online_extractor, momentum_extractor,
                 online_state=None, momentum_state=None, verbose: bool = True):
        """→ (online accuracy, momentum accuracy); ``*_state`` are the
        models' state dicts to snapshot on a new best."""
        from daliid_tpu_torch.train.checkpoint import save_weights

        acc_online = msmt17_balanced_accuracy(self.train_table, self.val_table,
                                              online_extractor, verbose=verbose)
        acc_momentum = msmt17_balanced_accuracy(self.train_table, self.val_table,
                                                momentum_extractor, verbose=verbose)
        best = max(acc_online, acc_momentum)
        if best > self.best_accuracy:
            self.best_accuracy, self.best_iter = best, pipeline_iter
            if self.save_dir and online_state is not None:
                os.makedirs(self.save_dir, exist_ok=True)
                for which, state in (("online", online_state), ("momentum", momentum_state)):
                    if state is not None:
                        save_weights(os.path.join(
                            self.save_dir,
                            f"model_{which}_bestACC_{self.model_name}_{self.version}.pt"), state)
        if verbose:
            print(f"Best Balanced Accuracy: {self.best_accuracy:.2%} and best iter: "
                  f"{self.best_iter}")
        return acc_online, acc_momentum


def msmt17_balanced_accuracy(train_table: ReidTable, val_table: ReidTable, bundle_or_extractor,
                             img_size=(256, 128), batch_size: int = 512, device=None,
                             verbose: bool = True) -> float:
    """Center-based balanced accuracy on a validation split: per-class
    centers of the L2-normalized train features, the nearest center (by
    cosine) predicts each val sample, and the mean over val classes of the
    share predicted right."""
    extractor = (bundle_or_extractor if isinstance(bundle_or_extractor, FeatureExtractor)
                 else FeatureExtractor(bundle_or_extractor, img_size=img_size,
                                       batch_size=batch_size, device=device))
    train_fvs = _l2n(extractor.extract(train_table))
    val_fvs = _l2n(extractor.extract(val_table))
    labels = np.unique(train_table.pids)
    centers = _l2n(np.stack([train_fvs[train_table.pids == l].mean(axis=0) for l in labels]))
    predicted = labels[np.argmax(val_fvs @ centers.T, axis=1)]
    true_match = predicted == val_table.pids
    acc = float(np.mean([true_match[val_table.pids == l].mean()
                         for l in np.unique(val_table.pids)]))
    if verbose:
        print(f"Balanced Accuracy on Validation Set: {acc:.3%}")
    return acc
