"""Similarity-based training-subset mining.

Port of ``daliid_tpu/eval/subset.py::mine_subset`` (``:38-65``), the
reference's ``get_subset`` / ``get_subset_one_encoder``
(``Person-ReID/getFeatures.py:243-353``; dead code upstream, whose intent
the JAX package reconstructs): embed one selected sample and the whole
train set with one or more extractors, rank the train rows by the
(averaged) cosine similarity to the sample, and split them into the
closest ``top_k`` (or fraction ``perc_closest``) and the rest.

The embeddings come back to the host from :class:`FeatureExtractor`; each
is L2-normalized there (``x / (|x| + 1e-12)``, as the JAX package does),
and the similarity of the sample to the table is one ``torch.matmul`` on
the extractor's device. The order is numpy's ``argsort(-sims)`` on the
host, so ties fall as they do in the JAX package.

A multi-head extractor, whose extract is a tuple of head embeddings, is
refused with an error that names the model: the JAX function stacks such
a tuple into a (heads, N, D) array and fails in its product.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from daliid_tpu_torch.data.registry import ReidTable
from daliid_tpu_torch.eval.features import FeatureExtractor


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)


def mine_subset(selected_row: ReidTable, train_table: ReidTable,
                extractors: Sequence[FeatureExtractor], top_k: int | None = None,
                perc_closest: float | None = None):
    """→ (selected_indexes, non_selected_indexes) into ``train_table``,
    ordered by descending mean similarity to the selected sample. Pass
    exactly one of ``top_k`` and ``perc_closest`` (a fraction of the train
    set)."""
    if (top_k is None) == (perc_closest is None):
        raise ValueError("pass exactly one of top_k / perc_closest")
    sims = None
    for ex in extractors:
        sel, train = ex.extract(selected_row), ex.extract(train_table)
        if isinstance(sel, tuple) or isinstance(train, tuple):
            raise ValueError(f"mine_subset takes one embedding a row; {ex.bundle.name} returns "
                             f"a tuple of head embeddings (a multi-head model)")
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(ex.device)
        s = torch.matmul(put(_l2n(np.atleast_2d(sel))), put(_l2n(train)).T)[0].cpu().numpy()
        sims = s if sims is None else sims + s
    sims = sims / len(extractors)

    order = np.argsort(-sims)
    k = top_k if top_k is not None else int(len(train_table) * perc_closest)
    return order[:k], order[k:]
