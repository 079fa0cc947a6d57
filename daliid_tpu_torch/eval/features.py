"""Batched embedding extraction on one device.

Port of ``daliid_tpu/eval/features.py``: :class:`FeatureExtractor`
(``:44``) and :func:`extract_features` (``:378``).

- a producer thread decodes the next batch (PIL bicubic to uint8, a thread
  pool inside) while the device runs the current one (``:265-283``);
- each uint8 batch goes through pinned host memory with a ``non_blocking``
  copy, so host-to-device traffic stays uint8;
- normalize and forward run under ``torch.inference_mode()``; embeddings
  come back f32, fetched once at the end of an extract;
- the tail batch is padded to the fixed batch size and trimmed after
  (``:273-276``), so every forward sees one shape;
- a model whose forward takes ``camera_ids`` (the SIE-conditioned
  TransReID backbones) gets each image's camera id: a table's camids, or 0
  for bare paths and padding slots (``:98``, ``:181-184``, ``:251-255``).

Not ported yet: int8 extraction (``quantize``/``calibrate``), turbulence
galleries and the native C++ JPEG loader; the CLIs reject their flags.
"""

from __future__ import annotations

import concurrent.futures as cf
import inspect
import os
import queue
import threading
import time
from typing import Sequence

import numpy as np
import torch

from daliid_tpu_torch.augment.preprocess import decode_resize, normalize_images
from daliid_tpu_torch.data.registry import ReidTable


class FeatureExtractor:
    """Reusable extraction pipeline for one model bundle on its device."""

    def __init__(self, bundle, img_size=(256, 128), batch_size: int = 512,
                 device=None, decode_workers: int = 16):
        self.bundle = bundle
        self.img_size = tuple(img_size)
        self.batch_size = max(1, int(batch_size))
        params = next(bundle.module.parameters())
        self.device = params.device if device is None else torch.device(device)
        bundle.module.to(self.device).eval()
        self.decode_workers = max(1, min(decode_workers, 2 * (os.cpu_count() or 1)))
        self._takes_camera_ids = "camera_ids" in inspect.signature(
            bundle.module.forward).parameters

    def update_variables(self, state_dict) -> None:
        """Copy new weights into the module in place."""
        self.bundle.module.load_state_dict(state_dict, strict=True)

    def _decode_paths(self, paths: Sequence[str]) -> np.ndarray:
        h, w = self.img_size
        out = np.empty((len(paths), h, w, 3), dtype=np.uint8)

        def work(i):
            out[i] = decode_resize(paths[i], h, w)

        with cf.ThreadPoolExecutor(self.decode_workers) as ex:
            list(ex.map(work, range(len(paths))))
        return out

    def forward_batch(self, images_u8: np.ndarray, camera_ids: np.ndarray | None = None
                      ) -> torch.Tensor:
        """One (B, H, W, 3) uint8 batch (and, for SIE models, its (B,)
        camera ids, zeros if None) → (B, D) f32 embeddings on the device
        (not synchronized)."""
        x = torch.from_numpy(images_u8)
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        kw = {}
        if self._takes_camera_ids:
            cams = np.zeros(len(images_u8), np.int64) if camera_ids is None else camera_ids
            kw["camera_ids"] = torch.as_tensor(np.asarray(cams, np.int64), device=self.device)
        with torch.inference_mode():
            x = normalize_images(x, dtype=getattr(self.bundle.module, "dtype", torch.float32))
            return self.bundle.module(x, **kw).float()

    def extract(self, table_or_paths, verbose: bool = False) -> np.ndarray:
        """Embed every image → (N, feature_dim) float32 numpy array."""
        if isinstance(table_or_paths, ReidTable):
            paths = [str(p) for p in table_or_paths.paths]
            camids = np.asarray(table_or_paths.camids, np.int64)
        else:
            paths = [str(p) for p in table_or_paths]
            camids = np.zeros(len(paths), np.int64)
        n = len(paths)
        bs = self.batch_size
        num_batches = -(-n // bs)
        t0 = time.time()
        batch_q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def producer():
            try:
                for b in range(num_batches):
                    if stop.is_set():
                        return
                    chunk = paths[b * bs:(b + 1) * bs]
                    imgs = self._decode_paths(chunk)
                    cams = camids[b * bs:(b + 1) * bs]
                    if len(chunk) < bs:  # pad the tail to the fixed batch shape
                        imgs = np.concatenate(
                            [imgs, np.zeros((bs - len(chunk), *imgs.shape[1:]), np.uint8)])
                        cams = np.pad(cams, (0, bs - len(chunk)))
                    batch_q.put((imgs, cams, len(chunk)))
                batch_q.put(None)
            except BaseException as exc:  # surface decode errors to the caller
                batch_q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        outputs = []
        try:
            while True:
                item = batch_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                imgs, cams, valid = item
                outputs.append(self.forward_batch(imgs, cams)[:valid])
        except BaseException:
            # unblock a producer waiting on the full queue, then re-raise
            stop.set()
            while thread.is_alive():
                try:
                    batch_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            raise
        thread.join()
        if outputs:
            result = torch.cat(outputs).cpu().numpy()
        else:
            result = np.zeros((0, self.bundle.feature_dim), np.float32)
        if verbose:
            dt = time.time() - t0
            print(f"Features extracted in {dt:.2f} seconds ({n / max(dt, 1e-9):.0f} img/s)")
        return result


def extract_features(table_or_paths, bundle, img_size=(256, 128), batch_size: int = 512,
                     device=None, verbose: bool = False) -> np.ndarray:
    """One-shot wrapper: build a :class:`FeatureExtractor` and extract."""
    ex = FeatureExtractor(bundle, img_size=img_size, batch_size=batch_size, device=device)
    return ex.extract(table_or_paths, verbose=verbose)
