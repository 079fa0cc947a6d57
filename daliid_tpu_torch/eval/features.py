"""Batched embedding extraction on one device.

Port of ``daliid_tpu/eval/features.py``: :class:`FeatureExtractor`
(``:44``) and :func:`extract_features` (``:378``).

- a producer thread decodes the next batch to uint8 (the native JPEG
  loader for JPEGs, PIL bicubic on a thread pool otherwise:
  ``augment/preprocess.py::decode_images``, ``:219-236``) while the device
  runs the current one (``:265-283``);
- each uint8 batch goes through pinned host memory with a ``non_blocking``
  copy, so host-to-device traffic stays uint8;
- normalize and forward run under ``torch.inference_mode()``; embeddings
  come back f32, fetched once at the end of an extract;
- the tail batch is padded to the fixed batch size and trimmed after
  (``:273-276``), so every forward sees one shape;
- a model whose forward takes ``camera_ids`` (the SIE-conditioned
  TransReID backbones) gets each image's camera id: a table's camids, or 0
  for bare paths and padding slots (``:98``, ``:181-184``, ``:251-255``);
- a multi-head model's tuple output gives a tuple of (N, D_h) f32 arrays,
  one per head (``:300-370``);
- ``quantize='int8'``: post-training int8 extraction
  (:mod:`daliid_tpu_torch.ops.quantize`; ``:52-75``, ``:139-235``,
  ``:306-350``). The first extract calibrates lazily on its first
  ``calib_batches`` batches that carry real images (a running max of every
  layer's input absmax), holding those batches back and running them in
  int8 once the scales are final; a short batch is calibrated on its real
  rows tiled to the batch size (padding rows normalize to the most extreme
  constant image and would skew the scales), and an extract of nothing never
  calibrates. :meth:`FeatureExtractor.update_variables` drops the scales, so
  the next extract recalibrates on the new weights;
- ``turbulence_dir=`` embeds each image's pre-rendered turbulence copy at
  ``turb_strength`` instead of the image (the paper's distorted gallery,
  ``:236-258``): the paths are rewritten before decode, with the naming of
  ``dataset`` (default: the table's name; MSMT17's copies are
  pid-prefixed);
- in a gang of more than one rank (:mod:`daliid_tpu_torch.parallel`,
  ``:238-310``) the batch splits into one contiguous block a rank, each
  rank decoding and forwarding only its block, and
  :func:`~daliid_tpu_torch.parallel.mesh.gather_rows` returns the whole
  batch to every rank, so every rank returns the full (N, D). The batch
  size is rounded up to a multiple of the rank count. An int8 calibration
  batch merges each layer's absmax over the ranks with a MAX
  ``all_reduce``: the JAX package calibrates on the global batch
  (``:139-160``), so every rank quantizes with the scales one process
  would use.
"""

from __future__ import annotations

import inspect
import os
import queue
import threading
import time
from typing import Sequence

import numpy as np
import torch

from daliid_tpu_torch.augment.preprocess import decode_images, normalize_images
from daliid_tpu_torch.data.registry import ReidTable
from daliid_tpu_torch.data.turbulence import turbulence_path
from daliid_tpu_torch.ops import quantize as q8
from daliid_tpu_torch.parallel.mesh import all_reduce_, gather_rows, rank, world


class FeatureExtractor:
    """Reusable extraction pipeline for one model bundle on its device."""

    def __init__(self, bundle, img_size=(256, 128), batch_size: int = 512,
                 device=None, decode_workers: int = 16, quantize: str | None = None,
                 calib_batches: int = 1):
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        if calib_batches < 1:
            raise ValueError(f"calib_batches must be >= 1, got {calib_batches}")
        self.quantize = quantize
        self.calib_batches = int(calib_batches)
        self.quant_scales = None  # {layer name: absmax}, set by calibrate()
        self._calib_final = False
        self._plan = None  # the int8 forwards, built when the scales are final
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
        """Copy new weights into the module in place; int8 scales calibrated
        on the old weights are dropped, so the next extract recalibrates."""
        self.bundle.module.load_state_dict(state_dict, strict=True)
        if self.quant_scales is not None or self._calib_final:
            self.quant_scales = None
            self._plan = None
            self._calib_final = False

    def calibrate(self, images_u8: np.ndarray, camera_ids=None, rebuild: bool = True) -> None:
        """Int8 calibration on one uint8 batch: every quantizable layer's
        input absmax, merged as a running max with earlier calibration
        batches; with ``rebuild`` the scales become final and the int8
        forward is built. The extract loop passes ``rebuild=False`` for each
        of its calibration batches and finalizes once."""
        new = {}
        if len(images_u8):
            x, kw = self._inputs(images_u8, camera_ids)
            new = q8.calibrate(self.bundle.module, x, **kw)
        if world() > 1:
            new = self._max_over_ranks(new)
        if self.quant_scales is None:
            self.quant_scales = new
        else:
            self.quant_scales = {k: max(self.quant_scales.get(k, 0.0), v)
                                 for k, v in new.items()}
        if rebuild:
            self._finalize_calibration()

    def _max_over_ranks(self, stats: dict) -> dict:
        """Each layer's absmax, the largest over the gang's ranks; a layer
        no rank ran (-1 on every rank) is left out, as one process leaves
        it out. A rank without real images passes an empty ``stats``."""
        names = sorted(q8.quant_layers(self.bundle.module))
        vec = torch.tensor([stats.get(n, -1.0) for n in names], dtype=torch.float64,
                           device=self.device)
        vals = all_reduce_(vec, "max").tolist()
        return {n: v for n, v in zip(names, vals) if v >= 0.0}

    def _finalize_calibration(self) -> None:
        # degenerate (<= 0) scales are left out: a conv without a scale
        # stays in floating point, a Dense layer takes dynamic scales
        self._calib_final = True
        self._plan = q8.prepare(self.bundle.module,
                                {k: v for k, v in self.quant_scales.items() if v > 0.0})

    def _decode_paths(self, paths: Sequence[str]) -> np.ndarray:
        return decode_images(paths, *self.img_size, self.decode_workers)

    def forward_batch(self, images_u8: np.ndarray, camera_ids: np.ndarray | None = None):
        """One (B, H, W, 3) uint8 batch (and, for SIE models, its (B,)
        camera ids, zeros if None) → (B, D) f32 embeddings on the device, or
        a tuple of them for a multi-head model (not synchronized)."""
        x, kw = self._inputs(images_u8, camera_ids)
        with torch.inference_mode(), q8.quantized(self.bundle.module, self._plan or {}):
            out = self.bundle.module(x, **kw)
        return tuple(o.float() for o in out) if isinstance(out, tuple) else out.float()

    def _inputs(self, images_u8: np.ndarray, camera_ids):
        """The normalized batch on the device and the forward's keywords."""
        x = torch.from_numpy(images_u8)
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        kw = {}
        if self._takes_camera_ids:
            cams = np.zeros(len(images_u8), np.int64) if camera_ids is None else camera_ids
            kw["camera_ids"] = torch.as_tensor(np.asarray(cams, np.int64), device=self.device)
        with torch.inference_mode():
            x = normalize_images(x, dtype=getattr(self.bundle.module, "dtype", torch.float32))
        return x, kw

    def extract(self, table_or_paths, turbulence_dir: str | None = None,
                turb_strength: int | None = None, dataset: str | None = None,
                verbose: bool = False):
        """Embed every image (or, with ``turbulence_dir``, its turbulence
        copy at ``turb_strength``) → (N, feature_dim) float32 numpy array,
        or a tuple of (N, D_h) arrays for a multi-head model."""
        if isinstance(table_or_paths, ReidTable):
            paths = [str(p) for p in table_or_paths.paths]
            camids = np.asarray(table_or_paths.camids, np.int64)
            dataset = dataset or table_or_paths.name
        else:
            paths = [str(p) for p in table_or_paths]
            camids = np.zeros(len(paths), np.int64)
        if turbulence_dir:
            paths = [turbulence_path(p, turbulence_dir, turb_strength, dataset) for p in paths]
        n = len(paths)
        # in a gang each rank takes one block of ``lb`` rows of every batch
        n_ranks = world()
        lb = -(-self.batch_size // n_ranks)
        bs = lb * n_ranks
        lo = rank() * lb
        num_batches = -(-n // bs)
        t0 = time.time()
        batch_q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def producer():
            try:
                for b in range(num_batches):
                    if stop.is_set():
                        return
                    valid = min(bs, n - b * bs)
                    mine = paths[b * bs + lo:b * bs + min(lo + lb, valid)]
                    imgs = (self._decode_paths(mine) if mine
                            else np.zeros((0, *self.img_size, 3), np.uint8))
                    cams = camids[b * bs + lo:b * bs + lo + len(mine)]
                    if len(mine) < lb:  # pad the tail to the fixed batch shape
                        imgs = np.concatenate(
                            [imgs, np.zeros((lb - len(mine), *imgs.shape[1:]), np.uint8)])
                        cams = np.pad(cams, (0, lb - len(mine)))
                    batch_q.put((b, imgs, cams, valid, len(mine)))
                batch_q.put(None)
            except BaseException as exc:  # surface decode errors to the caller
                batch_q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        outputs = []
        pending = []  # batches held back while the int8 calibration accumulates
        calib_seen = 0

        def run_batch(imgs, cams, valid):
            out = self.forward_batch(imgs, cams)
            if n_ranks > 1:
                out = (tuple(gather_rows(o, [lb] * n_ranks) for o in out)
                       if isinstance(out, tuple) else gather_rows(out, [lb] * n_ranks))
            outputs.append(tuple(o[:valid] for o in out) if isinstance(out, tuple)
                           else out[:valid])

        try:
            while True:
                item = batch_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                b, imgs, cams, valid, real = item
                if self.quantize is not None and not self._calib_final and valid > 0:
                    # calibrate on this rank's real rows, tiled over the padding
                    reps = -(-lb // max(real, 1))
                    self.calibrate(np.tile(imgs[:real], (reps, 1, 1, 1))[:lb],
                                   np.tile(cams[:real], reps)[:lb], rebuild=False)
                    calib_seen += 1
                    pending.append((imgs, cams, valid))
                    if calib_seen >= self.calib_batches or b == num_batches - 1:
                        self._finalize_calibration()
                        for p in pending:
                            run_batch(*p)
                        pending.clear()
                    continue
                run_batch(imgs, cams, valid)
            if pending:  # fewer real batches than calib_batches: commit what there is
                self._finalize_calibration()
                for p in pending:
                    run_batch(*p)
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
        if outputs and isinstance(outputs[0], tuple):
            result = tuple(torch.cat(head).cpu().numpy() for head in zip(*outputs))
        elif outputs:
            result = torch.cat(outputs).cpu().numpy()
        else:
            result = np.zeros((0, self.bundle.feature_dim), np.float32)
        if verbose:
            dt = time.time() - t0
            print(f"Features extracted in {dt:.2f} seconds ({n / max(dt, 1e-9):.0f} img/s)")
        return result


def extract_features(table_or_paths, bundle, img_size=(256, 128), batch_size: int = 512,
                     device=None, turbulence_dir: str | None = None,
                     turb_strength: int | None = None, dataset: str | None = None,
                     verbose: bool = False, quantize: str | None = None,
                     calib_batches: int = 1):
    """One-shot wrapper: build a :class:`FeatureExtractor` and extract."""
    ex = FeatureExtractor(bundle, img_size=img_size, batch_size=batch_size, device=device,
                          quantize=quantize, calib_batches=calib_batches)
    return ex.extract(table_or_paths, turbulence_dir=turbulence_dir,
                      turb_strength=turb_strength, dataset=dataset, verbose=verbose)
