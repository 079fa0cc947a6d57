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

Not ported yet: k-reciprocal re-ranking (``rerank=True``) and the sharded,
multi-host index.
"""

from __future__ import annotations

import numpy as np
import torch

from daliid_tpu_torch.device import resolve_device
from daliid_tpu_torch.ops.search_topk import MAX_K, f32_search_topk, sq8_search_topk


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
        self._capacity = 1 << (max(n, 1) - 1).bit_length()  # next power of two
        buf = np.zeros((self._capacity, g_rows.shape[1]), np.float32)
        buf[:n] = g_rows
        if not normalized:
            for i in range(0, n, 1 << 16):
                blk = buf[i : min(i + (1 << 16), n)]
                blk /= np.linalg.norm(blk, axis=1, keepdims=True) + 1e-12
        self._host_buf = buf
        if self.quantize == "int8":
            qbuf = np.zeros(buf.shape, np.int8)
            sbuf = np.zeros(self._capacity, np.float32)
            qbuf[:n], sbuf[:n] = _quantize_rows(buf[:n])
            self._gallery = torch.from_numpy(qbuf).to(self.device)
            self._gallery_scale = torch.from_numpy(sbuf).to(self.device)
        else:
            self._gallery = torch.from_numpy(buf).to(self.device)

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
            if self.quantize == "int8":
                q, s = _quantize_rows(f)
                self._gallery[off : off + n_new].copy_(torch.from_numpy(q))
                self._gallery_scale[off : off + n_new].copy_(torch.from_numpy(s))
            else:
                self._gallery[off : off + n_new].copy_(torch.from_numpy(f))
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

    def search(self, probe_fvs: np.ndarray, k: int = 10, rerank: bool = False):
        """→ (similarities (Q, k), gallery_indices (Q, k), pids (Q, k) or
        None). Probes are raw embeddings, normalized here; similarity is the
        cosine. ``k`` <= 64 runs kernel K3; a larger k the library route."""
        if rerank:
            raise NotImplementedError("k-reciprocal re-ranking (rerank=True) is not yet ported")
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
        if k > MAX_K:
            vals, idx = self._search_library(q, k)
        elif self.quantize == "int8":
            q8, q_scale = _quantize_rows(q)
            vals, idx = sq8_search_topk(
                torch.from_numpy(q8).to(self.device), self._gallery, self._gallery_scale,
                self.num_gallery, k,
            )
            # the probe's per-row scale is rank-invariant → applied after the kernel
            vals = vals * torch.from_numpy(q_scale).to(self.device)[:, None]
        else:
            vals, idx = f32_search_topk(torch.from_numpy(q).to(self.device), self._gallery,
                                        self.num_gallery, k)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        pids = self.gallery_pids[idx] if self.gallery_pids is not None else None
        return vals, idx, pids

    def _search_library(self, q: np.ndarray, k: int):
        """The JAX matcher's XLA route for k above K3's cap: every score of
        the live rows, then a stable descending sort (ties lowest index
        first). SQ8 scores take the XLA route's order, ``acc * q_scale *
        g_scale``, over an exact integer product (float64 holds every int8
        dot product), so they are bit-exact with the JAX index."""
        n = self.num_gallery
        if self.quantize == "int8":
            q8, q_scale = _quantize_rows(q)
            acc = torch.from_numpy(q8).to(self.device).double() @ self._gallery[:n].double().T
            sims = (acc.float() * torch.from_numpy(q_scale).to(self.device)[:, None]
                    * self._gallery_scale[None, :n])
        else:
            sims = torch.from_numpy(q).to(self.device) @ self._gallery[:n].T
        vals, idx = torch.sort(sims, dim=1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k].to(torch.int32)
