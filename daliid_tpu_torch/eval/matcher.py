"""Gallery index + identity search on one device — the serving path.

Port of ``daliid_tpu/eval/matcher.py``: :class:`GalleryIndex`
(``:105-407``), :func:`serving_embedding` (``:73``) and
:func:`_quantize_rows` (``:51-70``, numpy, copied) on a single device.

The L2-normalized gallery lives in a capacity-sized host f32 buffer (exact
copy for add/remove/save) and on the device, padded to a power-of-two
capacity; ``add`` writes only the new rows into the device tensor in place
while the capacity holds. ``quantize="int8"`` stores the device gallery as
symmetric per-row int8 (SQ8). ``search`` routes as the JAX matcher does
(``matcher.py:277,308-320``): k <= 64 runs kernel K3
(``ops/search_topk.py``) and applies the probe's own scale after it
(``:301``); a larger k takes the library product and a stable descending
sort, so ties come out lowest index first as in ``jax.lax.top_k``.
``save``/``load`` use the JAX package's ``.npz`` schema (``gallery``,
``pids``, ``quantize``), so either package loads the other's file.

``search(rerank=True)`` re-orders each probe's shortlist of
``rerank_depth`` rows by k-reciprocal re-ranking (``:344-430``): the
shortlist is fetched as above at ``min(max(k, depth), num_gallery)`` (K3
up to 64), its distances are recomputed in f32 from the exact host copy
with the JAX matcher's numpy expressions (so an SQ8 index re-ranks in f32
too), and :func:`~daliid_tpu_torch.eval.rerank.rerank_shortlists` runs on
the index's device.

In a gang of more than one rank (:mod:`daliid_tpu_torch.parallel`) the
index is sharded as the JAX index is over its ``data`` axis
(``:117-171``, ``:252-345``): every rank holds the whole f32 host copy, the
capacity is the rank count times a per-rank power of two, and each rank's
device holds its contiguous block of the rows. A search runs K3 (or the
library route for k > 64) over the rank's block for its local top-k; the
candidates, with their global indices, are all-gathered and merged by
(score descending, index ascending) into the global top-k, which every rank
returns. ``add`` writes the new rows into the blocks they fall in while the
capacity holds; ``remove`` rebuilds. Re-ranking reads the host copy.
"""

from __future__ import annotations

import numpy as np
import torch

from daliid_tpu_torch.device import resolve_device
from daliid_tpu_torch.eval.rerank import rerank_shortlists
from daliid_tpu_torch.ops.search_topk import MAX_K, f32_search_topk, sq8_search_topk
from daliid_tpu_torch.parallel.mesh import gather_rows, rank, world


def _quantize_rows(x: np.ndarray, _chunk: int = 1 << 16) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8: q = round(x / s), s = absmax/127 per row,
    chunked over rows so temporaries stay small at capacity scale."""
    n = x.shape[0]
    q = np.empty(x.shape, np.int8)
    scale = np.empty(n, np.float32)
    for i in range(0, n, _chunk):
        blk = x[i : i + _chunk]
        s = np.abs(blk).max(axis=1) / 127.0
        s = np.maximum(s, 1e-12, dtype=np.float32)
        t = np.rint(blk / s[:, None])
        np.clip(t, -127, 127, out=t)
        q[i : i + _chunk] = t
        scale[i : i + _chunk] = s
    return q, scale


def serving_embedding(fvs) -> np.ndarray:
    """One (N, D) serving vector per image; multi-head tuples concatenate
    along the feature axis."""
    if isinstance(fvs, (tuple, list)):
        return np.concatenate([np.asarray(f, np.float32) for f in fvs], axis=1)
    return np.asarray(fvs, np.float32)


class GalleryIndex:
    """Device-resident searchable gallery with incremental enrollment."""

    def __init__(self, gallery_fvs: np.ndarray, gallery_pids=None, quantize: str | None = None,
                 device="cuda"):
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        self.quantize = quantize
        self.device = resolve_device(device)
        self._ranks = world()
        self.gallery_pids = None if gallery_pids is None else np.asarray(gallery_pids)
        self._commit(serving_embedding(gallery_fvs), normalized=False)

    @property
    def _host_gallery(self) -> np.ndarray:
        """View of the live rows of the capacity-sized host buffer."""
        return self._host_buf[: self.num_gallery]

    def _commit(self, g_rows: np.ndarray, normalized: bool = True) -> None:
        """Full rebuild + upload: init, ``remove`` and capacity growth.
        ``normalized=False`` L2-normalizes chunk-wise in place."""
        n = g_rows.shape[0]
        self.num_gallery = n
        # a power of two a rank (next power of two of its share)
        self._per_rank = 1 << (max(-(-n // self._ranks), 1) - 1).bit_length()
        self._capacity = self._ranks * self._per_rank
        self._base = rank() * self._per_rank  # this rank's first row
        buf = np.zeros((self._capacity, g_rows.shape[1]), np.float32)
        buf[:n] = g_rows
        if not normalized:
            for i in range(0, n, 1 << 16):
                blk = buf[i : min(i + (1 << 16), n)]
                blk /= np.linalg.norm(blk, axis=1, keepdims=True) + 1e-12
        self._host_buf = buf
        block = slice(self._base, self._base + self._per_rank)
        if self.quantize == "int8":
            qbuf = np.zeros((self._per_rank, buf.shape[1]), np.int8)
            sbuf = np.zeros(self._per_rank, np.float32)
            mine = buf[:n][block]
            qbuf[:len(mine)], sbuf[:len(mine)] = _quantize_rows(mine)
            self._gallery = torch.from_numpy(qbuf).to(self.device)
            self._gallery_scale = torch.from_numpy(sbuf).to(self.device)
        else:
            self._gallery = torch.from_numpy(buf[block]).to(self.device)

    def add(self, fvs: np.ndarray, pids=None) -> None:
        """Enroll rows (raw embeddings; normalized here): an in-place copy of
        the new rows while they fit the capacity, a rebuild otherwise."""
        f = serving_embedding(fvs)
        if (self.gallery_pids is None) != (pids is None):
            raise ValueError("pids must be provided iff the index tracks pids")
        if f.ndim != 2 or f.shape[1] != self._host_buf.shape[1]:
            raise ValueError(
                f"embedding shape {f.shape} does not match the index's "
                f"feature dim {self._host_buf.shape[1]}"
            )
        if pids is not None and len(np.asarray(pids)) != f.shape[0]:
            raise ValueError(f"{len(pids)} pids for {f.shape[0]} rows")
        f = f / (np.linalg.norm(f, axis=1, keepdims=True) + 1e-12)
        n_new = f.shape[0]
        if n_new == 0:
            return
        off = self.num_gallery
        if off + n_new > self._capacity:
            self._commit(np.concatenate([self._host_gallery, f]))
        else:
            self._host_buf[off : off + n_new] = f
            self.num_gallery = off + n_new
            # the new rows that fall in this rank's block
            lo = max(off, self._base)
            hi = min(off + n_new, self._base + self._per_rank)
            if lo < hi:
                rows, dst = f[lo - off : hi - off], slice(lo - self._base, hi - self._base)
                if self.quantize == "int8":
                    q, s = _quantize_rows(rows)
                    self._gallery[dst].copy_(torch.from_numpy(q))
                    self._gallery_scale[dst].copy_(torch.from_numpy(s))
                else:
                    self._gallery[dst].copy_(torch.from_numpy(rows))
        # pids last: a failed add leaves the pid table consistent with the rows
        if pids is not None:
            self.gallery_pids = np.concatenate([self.gallery_pids, np.asarray(pids)])

    def remove(self, indices) -> None:
        """Retire gallery rows by index (as returned by ``search``)."""
        keep = np.ones(self.num_gallery, bool)
        keep[np.asarray(indices, dtype=np.intp)] = False
        if self.gallery_pids is not None:
            self.gallery_pids = self.gallery_pids[keep]
        self._commit(self._host_gallery[keep])

    def save(self, path: str) -> None:
        payload = {"gallery": self._host_gallery}
        if self.gallery_pids is not None:
            payload["pids"] = self.gallery_pids
        if self.quantize is not None:
            payload["quantize"] = np.str_(self.quantize)
        np.savez(path, **payload)

    @classmethod
    def load(cls, path: str, quantize: str | None = "auto", device="cuda") -> "GalleryIndex":
        """``quantize="auto"`` restores the saved index's mode; None or
        "int8" override it."""
        with np.load(path) as z:
            g = z["gallery"] if "gallery" in z.files else z["embeddings"]
            pids = z["pids"] if "pids" in z.files else None
            if quantize == "auto":
                quantize = str(z["quantize"]) if "quantize" in z.files else None
            return cls(g, pids, quantize=quantize, device=device)

    def search(self, probe_fvs: np.ndarray, k: int = 10, rerank: bool = False,
               rerank_depth: int = 64, rerank_k1: int = 20, rerank_k2: int = 6,
               rerank_lambda: float = 0.3):
        """→ (similarities (Q, k), gallery_indices (Q, k), pids (Q, k) or
        None). Probes are raw embeddings, normalized here; similarity is the
        cosine. A fetch of k <= 64 runs kernel K3; a larger one the library
        route.

        ``rerank=True`` re-orders each probe's top-``rerank_depth``
        shortlist by k-reciprocal re-ranking, in f32 from the exact host
        copy even on an SQ8 index; the scores are then ``1 - re-ranked
        distance``. With one probe and ``rerank_depth >= num_gallery`` this
        equals :func:`~daliid_tpu_torch.eval.rerank.re_ranking` on the
        probe's and the gallery's cosine distances."""
        q = serving_embedding(probe_fvs)
        if q.ndim != 2 or q.shape[1] != self._host_buf.shape[1]:
            raise ValueError(
                f"probe shape {q.shape} does not match the index's "
                f"feature dim {self._host_buf.shape[1]}"
            )
        q = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-12)
        k = min(k, self.num_gallery)
        if k == 0:
            idx = np.zeros((q.shape[0], 0), np.int32)
            pids = self.gallery_pids[idx] if self.gallery_pids is not None else None
            return np.zeros((q.shape[0], 0), np.float32), idx, pids
        k_fetch = min(max(k, rerank_depth), self.num_gallery) if rerank else k
        vals, idx = self._local_topk(q, min(k_fetch, self._per_rank), k_fetch)
        if self._ranks > 1:
            vals, idx = self._merge(vals, idx, k_fetch)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        if rerank and self.num_gallery > 1:
            vals, idx = self._rerank_shortlist(q, idx, k, rerank_k1, rerank_k2, rerank_lambda)
        else:
            vals, idx = vals[:, :k], idx[:, :k]
        pids = self.gallery_pids[idx] if self.gallery_pids is not None else None
        return vals, idx, pids

    def _local_topk(self, q: np.ndarray, k: int, k_fetch: int):
        """This rank's top-``k`` over its block of the live rows, as global
        (value, index) pairs; (-inf, -1) past its live rows. K3 when the
        fetch is within its cap, the library route otherwise."""
        num_real = min(max(self.num_gallery - self._base, 0), self._per_rank)
        if k_fetch > MAX_K:
            vals, idx = self._search_library(q, k, num_real)
        elif self.quantize == "int8":
            q8, q_scale = _quantize_rows(q)
            vals, idx = sq8_search_topk(
                torch.from_numpy(q8).to(self.device), self._gallery, self._gallery_scale,
                num_real, k,
            )
            # the probe's per-row scale is rank-invariant → applied after the kernel
            vals = vals * torch.from_numpy(q_scale).to(self.device)[:, None]
        else:
            vals, idx = f32_search_topk(torch.from_numpy(q).to(self.device), self._gallery,
                                        num_real, k)
        return vals, torch.where(idx >= 0, idx + self._base, idx)

    def _merge(self, vals: torch.Tensor, idx: torch.Tensor, k: int):
        """Every rank's candidates → the global top-``k``. Each rank's list
        is ordered (value descending, index ascending) and the blocks are in
        rank order, so a stable descending sort of the concatenation keeps
        ties lowest index first (the JAX merge's ``top_k``)."""
        sizes = [vals.shape[1]] * self._ranks
        all_v = gather_rows(vals.T.contiguous(), sizes).T  # (Q, ranks * k_local)
        all_i = gather_rows(idx.T.contiguous(), sizes).T
        order = torch.sort(all_v, dim=1, descending=True, stable=True).indices[:, :k]
        return torch.take_along_dim(all_v, order, dim=1), torch.take_along_dim(all_i, order, dim=1)

    def _rerank_shortlist(self, q: np.ndarray, idx: np.ndarray, k: int, k1: int, k2: int,
                          lam: float):
        """k-reciprocal re-rank of each probe's shortlist: rows from the
        exact f32 host copy, distances by the JAX matcher's numpy
        expressions (``matcher.py:412-421``), re-ranking on the device, a
        stable sort of the re-ranked distances."""
        depth = idx.shape[1]
        cands = self._host_buf[idx]                      # (Q, depth, D) f32
        qg = 1.0 - np.einsum("qd,qjd->qj", q, cands)
        gg = 1.0 - np.einsum("qid,qjd->qij", cands, cands)
        fulls = np.zeros((idx.shape[0], 1 + depth, 1 + depth), np.float32)
        fulls[:, 0, 1:] = qg
        fulls[:, 1:, 0] = qg
        fulls[:, 1:, 1:] = gg
        new_dist = rerank_shortlists(torch.from_numpy(fulls).to(self.device), k1=min(k1, depth),
                                     k2=min(k2, depth), lambda_value=float(lam)).cpu().numpy()
        order = np.argsort(new_dist, axis=1, kind="stable")[:, :k]
        return (1.0 - np.take_along_axis(new_dist, order, axis=1),
                np.take_along_axis(idx, order, axis=1))

    def _search_library(self, q: np.ndarray, k: int, n: int):
        """The JAX matcher's XLA route for k above K3's cap: every score of
        the block's ``n`` live rows, then a stable descending sort (ties
        lowest index first), (-inf, -1) past them. SQ8 scores take the XLA
        route's order, ``acc * q_scale * g_scale``, over an exact integer
        product (float64 holds every int8 dot product), so they are
        bit-exact with the JAX index."""
        if self.quantize == "int8":
            q8, q_scale = _quantize_rows(q)
            acc = torch.from_numpy(q8).to(self.device).double() @ self._gallery[:n].double().T
            sims = (acc.float() * torch.from_numpy(q_scale).to(self.device)[:, None]
                    * self._gallery_scale[None, :n])
        else:
            sims = torch.from_numpy(q).to(self.device) @ self._gallery[:n].T
        vals, idx = torch.sort(sims, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
        if vals.shape[1] < k:  # a block with fewer live rows than k
            pad = k - vals.shape[1]
            vals = torch.cat([vals, vals.new_full((vals.shape[0], pad), float("-inf"))], dim=1)
            idx = torch.cat([idx, idx.new_full((idx.shape[0], pad), -1)], dim=1)
        return vals, idx
