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
Not ported yet: the sharded path (the evaluate CLI rejects its flag).
"""

from __future__ import annotations

import numpy as np
import torch

from daliid_tpu_torch.data.registry import ReidTable
from daliid_tpu_torch.device import resolve_device
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.eval.rerank import re_ranking
from daliid_tpu_torch.metrics.ranking import cosine_distance_matrix, evaluate_rank


class Validator:
    """Standard Market-protocol validation: extract → cosine distmat on the
    device → CMC/mAP through kernel K2."""

    # protocol knobs the BRIAR subclass overrides
    _count_all = False       # average over matched queries only (Market)
    _ignore_camera = False   # same-(pid, camid) junk filtering on
    _report_map = True       # BRIAR reports mAP as 0

    def __init__(self, img_size=(256, 128), batch_size: int = 512, device="cuda",
                 max_rank: int = 50, rerank: bool = False):
        self.img_size = img_size
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.max_rank = max_rank
        self.rerank = rerank  # the commented path at validateModels.py:49-53

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
        """CMC/mAP straight from raw embeddings (full distmat, one device);
        head tuples through :meth:`multihead_distance_matrix`."""
        if isinstance(q_fvs, (tuple, list)):
            if self.rerank:
                raise ValueError("re-ranking a multi-head ensemble is undefined upstream "
                                 "(evaluate.py never combines them); rerank per head instead")
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
        """→ (cmc, mAP, distmat as numpy). Takes a ModelBundle or a reusable
        FeatureExtractor."""
        extractor = (
            bundle_or_extractor
            if isinstance(bundle_or_extractor, FeatureExtractor)
            else FeatureExtractor(bundle_or_extractor, img_size=self.img_size,
                                  batch_size=self.batch_size, device=self.device)
        )
        q_fvs = extractor.extract(queries, verbose=verbose)
        g_fvs = extractor.extract(gallery, verbose=verbose)
        if isinstance(q_fvs, tuple):
            distmat = self.multihead_distance_matrix(q_fvs, g_fvs)
        else:
            distmat = self.reranked_distance_matrix(q_fvs, g_fvs, verbose=verbose)
        cmc, mAP = self.rank(distmat, queries, gallery)
        if verbose:
            print(f"** Results ** mAP: {mAP:.2%}")
            for r in (1, 5, 10):
                print(f"Rank-{r:<3}: {cmc[r - 1]:.2%}")
        return cmc, mAP, distmat.cpu().numpy()


class BriarValidator(Validator):
    """BRIAR-style CMC: no junk filtering, every query counted, mAP 0."""

    _count_all = True
    _ignore_camera = True
    _report_map = False

    def __init__(self, img_size=(256, 128), batch_size: int = 512, device="cuda",
                 max_rank: int = 20, rerank: bool = False):
        super().__init__(img_size=img_size, batch_size=batch_size, device=device,
                         max_rank=max_rank, rerank=rerank)


def get_validator(dataset_name: str, **kw) -> Validator:
    if dataset_name == "BRIAR":
        return BriarValidator(**kw)
    return Validator(**kw)
