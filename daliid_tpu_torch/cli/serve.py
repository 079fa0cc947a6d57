"""Persistent identification service: a TCP daemon over the serving index.

Port of ``daliid_tpu/cli/serve.py``: :class:`IdentificationService`
(``:109-360``), the newline-JSON TCP server (``:363-428``) and :func:`main`
(``:431``), flag for flag plus ``--device``. One extractor and one
:class:`~daliid_tpu_torch.eval.matcher.GalleryIndex` stay alive on the GPU;
searches run kernel K3. ``--quantize int8`` makes the extractor int8,
calibrated on the first request's images (``--calib_batches`` batches);
``--index_quantize`` is the index's own int8 storage.

Protocol — one JSON object per line, one JSON response line per request::

    {"op": "enroll", "paths": [...], "pids": [...]}        embed + add
    {"op": "enroll", "embeddings": [[...]], "pids": [...]} pre-computed
    {"op": "search", "paths": [...], "topk": 5}
    {"op": "search", "embeddings": [[...]], "topk": 5}
    {"op": "search", ..., "rerank": true, "rerank_depth": 64}  k-reciprocal
    {"op": "remove", "pids": [...]}                        drop identities
    {"op": "stats"}                                        index/model info
    {"op": "save", "path": "..."} / {"op": "load", "path": "..."}
    {"op": "shutdown"}

Responses are ``{"ok": true, ...}`` or ``{"ok": false, "error": "..."}``; a
failed request never kills the daemon. Connections are concurrent (one
handler thread each); requests that touch the device serialize on one
lock. Concurrent searches micro-batch: while one dispatch holds the device,
arriving searches queue, and the next thread to take the lock serves the
queue in one ``GalleryIndex.search`` per group (``:212-300``): all plain
searches share one dispatch at their largest k (exact searches are
prefix-identical), and re-ranked ones group by (depth, k), since the
re-ranked order depends on the shortlist; a re-ranked answer does not
depend on what else was in flight. ``--data_dir`` jails the save/load
paths (``:325-337``).

Usage::

    python -m daliid_tpu_torch serve --model_name resnet50 --port 7788 --index_quantize int8 &
    printf '%s\\n' '{"op":"stats"}' | nc 127.0.0.1 7788
"""

from __future__ import annotations

import argparse
import json
import os
import socketserver
import threading
import time

import numpy as np

from daliid_tpu_torch.device import add_device_flag, parse_dtype, resolve_device
from daliid_tpu_torch.eval.matcher import GalleryIndex, serving_embedding


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DaliID identification daemon (PyTorch/CUDA)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=7788, help="0 = ephemeral (port is printed)")
    p.add_argument("--model_name", type=str, default="resnet50")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--img_height", type=int, default=256)
    p.add_argument("--img_width", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--quantize", type=str, default=None, choices=["int8"],
                   help="int8 post-training quantization for extraction (ops/quantize.py); "
                        "calibrated on the first extract batches")
    p.add_argument("--calib_batches", type=int, default=1,
                   help="int8 calibration spans the first N extract batches (running "
                        "absmax)")
    p.add_argument(
        "--index_quantize", type=str, default=None, choices=["int8", "off"],
        help="'int8' stores the device gallery as per-row symmetric int8; "
             "'off' forces f32 when --load_index carries a saved int8 mode; "
             "default keeps the saved mode (f32 for fresh galleries)",
    )
    p.add_argument("--topk", type=int, default=10, help="default result depth")
    p.add_argument("--load_index", type=str, default=None, help="warm-start gallery .npz")
    p.add_argument(
        "--data_dir", type=str, default=None,
        help="jail for the save/load ops: request paths must resolve "
             "(realpath) under this directory",
    )
    add_device_flag(p)
    return p


class IdentificationService:
    """The op dispatcher; transport-agnostic (the TCP layer below and
    in-process callers both drive :meth:`handle`)."""

    def __init__(self, extractor, index: GalleryIndex | None, topk: int = 10,
                 index_quantize: str | None = None, model_name: str | None = None,
                 quantize_flag: str | None = None, data_dir: str | None = None,
                 device="cuda"):
        self.extractor = extractor
        self.index = index
        self.topk = topk
        self.index_quantize = index_quantize
        self.data_dir = data_dir
        self.device = device
        # the operator's literal --index_quantize (None = unset): an explicit
        # value also overrides the saved mode on {"op": "load"}
        self._quantize_flag = quantize_flag
        self.model_name = model_name
        self.shutdown_requested = False
        self._lock = threading.Lock()
        # search micro-batching: entries queue here while the device is busy
        self._pending: list = []
        self._pending_lock = threading.Lock()
        self._counters = {
            "requests": 0, "errors": 0, "busy_ms": 0.0,
            "search_requests": 0, "search_dispatches": 0,
        }

    def _embed(self, req: dict) -> np.ndarray:
        if ("paths" in req) == ("embeddings" in req):
            raise ValueError("provide exactly one of 'paths' or 'embeddings'")
        if "paths" in req:
            if self.extractor is None:
                raise ValueError("daemon started without a model; send 'embeddings'")
            return serving_embedding(self.extractor.extract([str(p) for p in req["paths"]]))
        fvs = np.asarray(req["embeddings"], np.float32)
        if fvs.ndim != 2:
            raise ValueError(f"embeddings must be 2-D, got shape {fvs.shape}")
        return fvs

    def handle(self, req: dict) -> dict:
        try:
            op = req.get("op")
            fn = getattr(self, f"_op_{op}", None)
            if op is None or fn is None:
                raise ValueError(f"unknown op {op!r}")
            if op == "search":
                return self._search_batched(req)
            with self._lock:
                self._counters["requests"] += 1
                t0 = time.monotonic()
                try:
                    return {"ok": True, **fn(req)}
                finally:
                    self._counters["busy_ms"] += (time.monotonic() - t0) * 1e3
        except Exception as exc:  # a bad request must never kill the daemon
            with self._lock:
                self._counters["errors"] += 1
            return {"ok": False, "error": f"{type(exc).__name__}: {exc}"}

    def _op_enroll(self, req: dict) -> dict:
        fvs = self._embed(req)
        pids = req.get("pids")
        if pids is not None and len(pids) != len(fvs):
            raise ValueError(f"{len(pids)} pids for {len(fvs)} embeddings")
        if self.index is None:
            # the first enroll decides whether this index tracks pids
            self.index = GalleryIndex(
                fvs, gallery_pids=np.asarray(pids) if pids is not None else None,
                quantize=self.index_quantize, device=self.device,
            )
        elif self.index.gallery_pids is None:
            if pids is not None:
                raise ValueError("this index does not track pids; omit 'pids'")
            self.index.add(fvs)
        else:
            if pids is None:
                raise ValueError("this index tracks pids; 'pids' is required")
            self.index.add(fvs, np.asarray(pids))
        return {"enrolled": int(len(fvs)), "num_gallery": int(self.index.num_gallery)}

    # handle() routes "search" to the batching path; this keeps the op table
    # honest for unknown-op detection
    _op_search = True

    def _search_batched(self, req: dict) -> dict:
        """Queue the request; whichever waiting thread next takes the device
        lock serves the whole queue in one ``index.search``. No wait timer:
        batches form exactly under contention."""
        entry = {"req": req, "event": threading.Event(), "result": None}
        with self._pending_lock:
            self._pending.append(entry)
        while not entry["event"].is_set():
            if not self._lock.acquire(timeout=0.05):
                continue
            try:
                with self._pending_lock:
                    batch, self._pending = self._pending, []
                if batch:
                    self._serve_search_batch(batch)
            finally:
                self._lock.release()
        return entry["result"]

    def _serve_search_batch(self, batch: list) -> None:
        t0 = time.monotonic()
        self._counters["requests"] += len(batch)
        self._counters["search_requests"] += len(batch)

        def fail(e, exc):
            self._counters["errors"] += 1
            e["result"] = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
            e["event"].set()

        groups: dict = {}
        for e in batch:
            try:
                if self.index is None or self.index.num_gallery == 0:
                    raise ValueError("gallery is empty — enroll first")
                fvs = self._embed(e["req"])
                if fvs.shape[1] != self.index._host_buf.shape[1]:
                    raise ValueError(
                        f"probe dim {fvs.shape[1]} != index dim {self.index._host_buf.shape[1]}"
                    )
                k = int(e["req"].get("topk", self.topk))
                # plain searches are exact, so one dispatch at the group's
                # largest k is prefix-identical for each; a re-ranked order
                # depends on the shortlist, so those group by (depth, k)
                if e["req"].get("rerank", False):
                    key = (True, int(e["req"].get("rerank_depth", 64)), k)
                else:
                    key = (False, 0, 0)
                groups.setdefault(key, []).append((e, fvs, k))
            except Exception as exc:
                fail(e, exc)
        for (rerank, depth, _), entries in groups.items():
            try:
                probes = np.concatenate([fvs for _, fvs, _ in entries])
                sims, ids, pids = self.index.search(
                    probes, k=max(k for _, _, k in entries), rerank=rerank,
                    rerank_depth=depth if rerank else 64)
                self._counters["search_dispatches"] += 1
                off = 0
                for e, fvs, k in entries:
                    n = fvs.shape[0]
                    s, i = sims[off:off + n, :k], ids[off:off + n, :k]
                    p = pids[off:off + n, :k] if pids is not None else None
                    off += n
                    e["result"] = {
                        "ok": True,
                        "sims": np.round(s, 6).tolist(),
                        "indices": i.tolist(),
                        "pids": p.tolist() if p is not None else None,
                    }
                    e["event"].set()
            except Exception as exc:
                for e, _, _ in entries:
                    if not e["event"].is_set():
                        fail(e, exc)
        self._counters["busy_ms"] += (time.monotonic() - t0) * 1e3

    def _op_remove(self, req: dict) -> dict:
        if self.index is None:
            raise ValueError("gallery is empty")
        if self.index.gallery_pids is None:
            raise ValueError("this index does not track pids; cannot remove by pid")
        mask = np.isin(np.asarray(self.index.gallery_pids), np.asarray(req["pids"]))
        self.index.remove(np.nonzero(mask)[0])
        return {"removed": int(mask.sum()), "num_gallery": int(self.index.num_gallery)}

    def _op_stats(self, req: dict) -> dict:
        return {
            "num_gallery": int(self.index.num_gallery) if self.index is not None else 0,
            "index_quantize": (self.index.quantize if self.index is not None
                               else self.index_quantize),
            "model": self.model_name,
            "requests": self._counters["requests"],
            "errors": self._counters["errors"],
            "busy_ms": round(self._counters["busy_ms"], 3),
            "search_requests": self._counters["search_requests"],
            "search_dispatches": self._counters["search_dispatches"],
        }

    def _jail(self, path: str) -> str:
        """Enforce the --data_dir jail on file-op paths."""
        if self.data_dir is None:
            return path
        root = os.path.realpath(self.data_dir)
        resolved = os.path.realpath(os.path.join(root, path))
        if resolved != root and not resolved.startswith(root + os.sep):
            raise ValueError(f"path escapes --data_dir: {path!r}")
        return resolved

    def _op_save(self, req: dict) -> dict:
        if self.index is None:
            raise ValueError("gallery is empty")
        path = self._jail(req["path"])
        self.index.save(path)
        return {"path": path}

    def _op_load(self, req: dict) -> dict:
        # the daemon's explicit --index_quantize wins over the saved mode
        flag = self._quantize_flag
        self.index = GalleryIndex.load(
            self._jail(req["path"]),
            quantize="auto" if flag is None else (None if flag == "off" else flag),
            device=self.device,
        )
        self.index_quantize = self.index.quantize
        return {"num_gallery": int(self.index.num_gallery)}

    def _op_shutdown(self, req: dict) -> dict:
        self.shutdown_requested = True
        return {}


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        service: IdentificationService = self.server.service  # type: ignore[attr-defined]
        for raw in self.rfile:
            raw = raw.strip()
            if not raw:
                continue
            try:
                req = json.loads(raw)
            except json.JSONDecodeError as exc:
                resp = {"ok": False, "error": f"bad JSON: {exc}"}
            else:
                resp = service.handle(req)
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()
            if service.shutdown_requested:
                self.server.shutdown_later()  # type: ignore[attr-defined]
                return


class _Server(socketserver.ThreadingTCPServer):
    """One handler thread per connection; the device serializes at the
    service lock. Handlers request shutdown through a flag that the serve
    loop polls in ``service_actions`` (``shutdown`` from a handler thread
    would deadlock ``serve_forever``)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, service: IdentificationService):
        super().__init__(addr, _Handler)
        self.service = service
        self._stop = False

    def shutdown_later(self):
        self._stop = True

    def service_actions(self):
        if self._stop:
            threading.Thread(target=self.shutdown, daemon=True).start()
            self._stop = False


def make_server(args, extractor=None) -> _Server:
    """Build the TCP server (callers read ``server_address`` for the port)."""
    device = resolve_device(args.device)
    flag = args.index_quantize
    index_quantize = None if flag == "off" else flag
    index = None
    if args.load_index:
        index = GalleryIndex.load(
            args.load_index, quantize="auto" if flag is None else index_quantize, device=device
        )
        index_quantize = index.quantize  # later enrolls follow the live index
    service = IdentificationService(
        extractor, index, topk=args.topk, index_quantize=index_quantize,
        model_name=args.model_name if extractor is not None else None,
        quantize_flag=flag, data_dir=args.data_dir, device=device,
    )
    return _Server((args.host, args.port), service)


def main(args):
    from daliid_tpu_torch.cli.evaluate import load_bundle
    from daliid_tpu_torch.eval.features import FeatureExtractor

    device = resolve_device(args.device)
    img_size = (args.img_height, args.img_width)
    bundle = load_bundle(args.model_name, args.model_path, img_size,
                         parse_dtype(args.compute_dtype), device)
    extractor = FeatureExtractor(bundle, img_size=img_size, batch_size=args.batch_size,
                                 device=device, quantize=args.quantize,
                                 calib_batches=args.calib_batches)
    server = make_server(args, extractor)
    host, port = server.server_address[:2]
    print(f"[serve] listening on {host}:{port} "
          f"(model {args.model_name}, index_quantize {args.index_quantize})", flush=True)
    try:
        server.serve_forever(poll_interval=0.1)
    finally:
        server.server_close()
    print("[serve] shut down")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(build_argparser().parse_args()))
