"""Training engine on one device: the train step, the EMA momentum model and
the epoch loop.

Port of ``daliid_tpu/train/trainer.py`` for models that return one (B, D)
embedding in train mode (the ResNet and ViT families and the rest of the
CNN zoo), for TransReID-JPM, which returns ``([scores], [feats])``, and for
a classifier-headed model (``densenet121`` with ``num_classes > 0``), which
returns ``(embedding, logits)``; the two tuples are told apart as the JAX
trainer does, by whether the first element is itself a list. The
reference trainer (``Person-ReID/train_encodersKIT.py:45-249``) and its
outer loop (``mainKIT.py:58-201``), step by step (``trainer.py:367-569``):

- augment the uint8 batch through kernel K1 (``augment/train_augment.py``),
  with scalars drawn from the trainer's CPU ``torch.Generator``;
- train-mode forward; a model whose forward takes them also gets the
  batch's camera ids (SIE), its labels (margin heads) and the trainer's
  drop-path ``torch.Generator`` on the device (``trainer.py:200-204,
  384-392``);
- for JPM (``trainer.py:396-437``): per-branch distortion-weighted cross
  entropy over the softmax of the scores and distortion-weighted softmax
  triplet on the L2-normalized branch features, each mixed 0.5 global +
  0.5 mean of the local branches; the embedding for the losses below is
  ``concat([global, locals / 4])``, the space the miner embeds in;
- for a classifier head (``trainer.py:438-447``): distortion-weighted
  cross entropy over the softmax of the logits;
- ``out / (||out|| + 1e-9)`` (``trainer.py:448``);
- center loss + ``lambda_proxy`` x proxy loss (+ the JPM or classifier terms, +
  ``lambda_distortion`` x the paired loss on [clean, distorted] pairs when
  it is > 0);
- backward; Adam with L2 decay folded into the gradient
  (``torch.optim.Adam(weight_decay=...)``, the semantics of the JAX
  ``make_optimizer``), its LR set per epoch from the 3-phase schedule;
- EMA of the momentum model over parameters and BN running statistics,
  ``beta * m + (1 - beta) * o``, updated in place.

``grad_accum`` splits the batch into strided chunks (pairs move as units,
:func:`microbatch_slots`) whose gradients are weighted by their valid-slot
counts before one Adam update and one EMA update; BN statistics thread
through the chunks in order. Each epoch first re-embeds the train set with
the online (or momentum) weights and mines centers and proxies; the first
mining keeps the table's decoded batches on the device where they fit, so
later minings decode nothing (``FeatureExtractor.extract(keep=True)``). A
prefetch thread decodes the next batch into pinned memory while the device
runs the current step. Step metrics stay on the device and are fetched once per
epoch. While a ``torch.profiler`` records, the epoch keeps program spans
(:func:`~daliid_tpu_torch.utils.profiling.span`): ``mine.extract`` and
``mine.host`` inside ``proxy_mining``; ``train.decode`` on the prefetch
thread, ``train.prefetch_wait`` and ``train.step`` inside ``finetuning``.

The RNG state (the augmentation and drop-path torch Generators and the
numpy PCG64 streams of the miner and the sampler) round-trips through
:meth:`Trainer.rng_state`, so a resumed run replays the stream of an
uninterrupted one.

In a gang (:mod:`daliid_tpu_torch.parallel`; ``trainer.py:216-232``,
``:300-330``, ``:620-670``) the sampler stays global and deterministic, so
every rank draws the same PK batch. Each rank decodes its contiguous block
of the batch's rows and runs K1 on it with its rows of the global (B, 16)
scalar table, so its pixels equal one process's rows bit for bit. The
forward runs on the block (BN reduces over the gang, ``models/norm.py``);
the model's outputs are all-gathered with a backward that keeps the rank's
own rows (``parallel/mesh.py::gather_rows``), so every rank computes the
global loss and metrics, and its backward carries its share: the gradient
through its rows of every sample term over the global denominator (the
weighted sums, the valid count). The gradients are then summed over the
ranks with one ``all_reduce`` before Adam; Adam and the EMA run alike on
every rank. With ``grad_accum`` each rank takes the strided chunks of its
own block; since the blocks are whole multiples of the chunk stride, the
ranks' chunk ``c`` together are one process's chunk ``c``, in its order,
with its valid-slot weight. Mining re-embeds through the gang extractor, so
every rank mines the same centers and proxies. Drop-path draws (the ViT
family) are each rank's own.
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import inspect
import os
import time
from typing import Dict

import numpy as np
import torch

from daliid_tpu_torch import losses as L
from daliid_tpu_torch.augment import train_augment as augment_mod
from daliid_tpu_torch.augment.preprocess import decode_images
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.models.factory import ModelBundle
from daliid_tpu_torch.parallel.mesh import active, all_reduce_, gather_rows, rank, world
from daliid_tpu_torch.train.proxies import mine_proxies_and_centers
from daliid_tpu_torch.train.sampler import PKBatchSampler
from daliid_tpu_torch.utils.profiling import PhaseTimer, adopt_span, current_span, span

_U64 = (1 << 64) - 1

# per-step metrics, in the order of the tensor train_step returns
METRICS = ("loss", "center_loss", "proxy_loss", "batch_acc_bal", "avg_max_prob", "weights_sum")


def _encode_pcg64(gen: np.random.Generator) -> np.ndarray:
    """PCG64 generator state → uint64[6] (two 128-bit ints split hi/lo,
    plus the buffered-uint32 carry), for storage inside a checkpoint."""
    st = gen.bit_generator.state
    if st["bit_generator"] != "PCG64":
        raise ValueError(f"only PCG64 generators are checkpointable, got {st['bit_generator']}")
    s, inc = st["state"]["state"], st["state"]["inc"]
    return np.asarray(
        [s >> 64, s & _U64, inc >> 64, inc & _U64, st["has_uint32"], st["uinteger"]],
        dtype=np.uint64,
    )


def _decode_pcg64(arr) -> np.random.Generator:
    a = [int(x) for x in np.asarray(arr, dtype=np.uint64)]
    gen = np.random.default_rng(0)
    gen.bit_generator.state = {
        "bit_generator": "PCG64",
        "state": {"state": (a[0] << 64) | a[1], "inc": (a[2] << 64) | a[3]},
        "has_uint32": a[4],
        "uinteger": a[5],
    }
    return gen


def lr_schedule_values(base_lr: float, num_epochs: int = 250) -> np.ndarray:
    """Per-epoch LR: 100 epochs at lr, 100 at lr/10, 50 at lr/100, truncated
    or extended to ``num_epochs`` (``mainKIT.py:129-132``)."""
    vals = np.concatenate(
        [np.full(100, base_lr), np.full(100, base_lr / 10), np.full(50, base_lr / 100)]
    )
    if num_epochs <= len(vals):
        return vals[:num_epochs]
    return np.concatenate([vals, np.full(num_epochs - len(vals), base_lr / 100)])


def microbatch_slots(batch: int, n: int, paired: bool) -> np.ndarray:
    """(n, batch//n) int32 slot indices of the grad-accum microbatches,
    STRIDED: chunk c takes slots ``c::n``; for paired batches the
    [clean, distorted] pairs stride as units. PK batches are grouped by
    identity, so contiguous chunks could hold a single identity."""
    if batch % n:
        raise ValueError(f"grad_accum={n} must divide the batch size {batch}")
    mb = batch // n
    if paired:
        if (batch // 2) % n:
            raise ValueError(
                f"paired AT batches microbatch in [clean, distorted] pair "
                f"units: grad_accum={n} must divide the pair count {batch // 2}"
            )
        pairs = np.arange(batch, dtype=np.int32).reshape(batch // 2, 2)
        return pairs.reshape(mb // 2, n, 2).swapaxes(0, 1).reshape(n, mb)
    return np.arange(batch, dtype=np.int32).reshape(mb, n).T.copy()


class Trainer:
    """Epoch-level orchestration mirroring ``trainer`` + ``mainKIT.main``,
    on the device of the online model."""

    def __init__(
        self,
        bundle_online: ModelBundle,
        bundle_momentum: ModelBundle,
        sampler: PKBatchSampler,
        img_size=(256, 128),
        base_lr: float = 3.5e-4,
        weight_decay: float = 5e-4,
        tau: float = 0.1,
        beta: float = 0.999,
        lambda_proxy: float = 1.0,
        lambda_distortion: float = 0.0,
        num_epochs: int = 250,
        num_proxies: int = 5,
        num_iter: int = 1,
        momentum_on_feature_extraction: bool = False,
        compute_dtype: torch.dtype = torch.bfloat16,
        seed: int = 12,
        decode_workers: int = 16,
        extractor_batch: int = 512,
        grad_accum: int = 1,
        mining_quantize: str | None = None,
        mining_calib_batches: int = 1,
    ):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self._ranks, self._rank = world(), rank()
        if self._ranks > 1:
            # each rank's block holds whole grad-accum chunks (whole pairs)
            unit = grad_accum * (2 if sampler.kind_of_transform == 1 else 1)
            if sampler.batch_size % (self._ranks * unit):
                raise ValueError(f"the batch of {sampler.batch_size} does not split into "
                                 f"{self._ranks} ranks of whole grad-accum chunks "
                                 f"(grad_accum={grad_accum})")
        self._local_batch = sampler.batch_size // self._ranks
        self.online = bundle_online.module.train()
        self.momentum = bundle_momentum.module.eval().requires_grad_(False)
        self.device = next(self.online.parameters()).device
        self.sampler = sampler
        self.img_size = tuple(img_size)
        self.tau = tau
        self.beta = beta
        self.lambda_proxy = lambda_proxy
        self.lambda_distortion = lambda_distortion
        self.paired_batches = sampler.kind_of_transform == 1
        self.num_epochs = num_epochs
        self.num_proxies = num_proxies
        self.num_iter = max(1, num_iter)
        self.momentum_on_feature_extraction = momentum_on_feature_extraction
        self.compute_dtype = compute_dtype
        self.grad_accum = int(grad_accum)
        self.decode_workers = max(1, min(decode_workers, 2 * (os.cpu_count() or 1)))
        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator().manual_seed(seed)
        self._drop_gen = torch.Generator(device=self.device).manual_seed(seed)
        takes = inspect.signature(self.online.forward).parameters
        self._takes_camera_ids = "camera_ids" in takes
        self._takes_labels = "labels" in takes
        self._takes_generator = "generator" in takes
        self.timer = PhaseTimer()
        self._lr_values = lr_schedule_values(base_lr, num_epochs)
        self.optimizer = torch.optim.Adam(self.online.parameters(), lr=base_lr,
                                          weight_decay=weight_decay)
        self._params = [p for p in self.online.parameters()]
        # EMA pairs over parameters AND buffers (BN running statistics), as
        # detached views that in-place updates and load_state_dict keep
        self._ema_dst = list(self.momentum.state_dict().values())
        self._ema_src = list(self.online.state_dict().values())
        # an eval-mode copy of the model for mining and validation, loaded
        # with the online or momentum weights when it is used
        self.extractor = FeatureExtractor(
            ModelBundle(module=copy.deepcopy(self.online).eval(),
                        feature_dim=bundle_online.feature_dim, name=bundle_online.name),
            img_size=self.img_size, batch_size=extractor_batch, device=self.device,
            decode_workers=decode_workers,
        )
        # the int8 mining extractor (``mining_quantize``), a separate one on
        # its own copy of the model, so that validation and evaluation stay
        # in full precision; update_variables drops its scales each epoch,
        # so mining recalibrates on the new weights (daliid_tpu/train/
        # trainer.py:256-275)
        self._mining_extractor = None
        if mining_quantize is not None:
            self._mining_extractor = FeatureExtractor(
                ModelBundle(module=copy.deepcopy(self.online).eval(),
                            feature_dim=bundle_online.feature_dim, name=bundle_online.name),
                img_size=self.img_size, batch_size=extractor_batch, device=self.device,
                decode_workers=decode_workers, quantize=mining_quantize,
                calib_batches=mining_calib_batches,
            )

    # ------------------------------------------------------------------
    # the step
    def augment(self, images_u8: torch.Tensor) -> torch.Tensor:
        """K1 over this rank's block of (B, H, W, 3) uint8 rows on the
        device, with the block's rows of the global scalar table."""
        b = images_u8.shape[0]
        return augment_mod.train_augment(images_u8, self._gen, dtype=self.compute_dtype,
                                         rows=(self._rank * b, self._ranks * b))

    def _forward(self, images, labels, camids):
        kw = {}
        if self._takes_camera_ids:
            kw["camera_ids"] = camids
        if self._takes_labels:
            kw["labels"] = labels
        if self._takes_generator:
            kw["generator"] = self._drop_gen
        return self.online(images, **kw)

    def _jpm_losses(self, scores, feats, labels, distortions, mask, epoch):
        """The JPM branch losses, each mixed 0.5 global + 0.5 mean local."""
        def mix(terms):
            return terms[0] if len(terms) == 1 else 0.5 * terms[0] + 0.5 * torch.stack(
                terms[1:]).mean()

        ce = [L.weighted_cross_entropy_loss(torch.softmax(s, dim=-1), labels, distortions, epoch,
                                            self.num_epochs, sample_mask=mask)[0]
              for s in scores]
        tri = [L.weighted_softmax_triplet_loss(
            f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-9), labels, distortions,
            epoch, self.num_epochs, tau=self.tau, sample_mask=mask) for f in feats]
        return mix(ce) + mix(tri)

    def _gathered(self, out):
        """The model's outputs of every rank's rows (the identity on one
        process)."""
        if self._ranks == 1:
            return out
        if isinstance(out, (tuple, list)):
            return type(out)(self._gathered(o) for o in out)
        return gather_rows(out, [out.shape[0]] * self._ranks)

    def _losses(self, images, labels, distortions, mask, camids, centers, proxies, proxy_labels,
                epoch, rows=None):
        """The loss terms of the global batch (chunk) whose labels, weights
        and mask are given; ``images`` are this rank's ``rows`` of it
        (all of them on one process)."""
        rows = slice(None) if rows is None else rows
        out = self._gathered(self._forward(images, labels[rows], camids[rows]))
        id_loss = None
        if isinstance(out, tuple) and len(out) == 2 and isinstance(out[0], (list, tuple)):
            # JPM in train mode: ([scores...], [feats...])
            scores, feats = out
            id_loss = self._jpm_losses(scores, feats, labels, distortions, mask, epoch)
            out = torch.cat([feats[0]] + [f / 4.0 for f in feats[1:]], dim=1)
        elif isinstance(out, tuple) and len(out) == 2:
            # a classifier-headed model (densenet121 with num_classes > 0,
            # Encoders.py:633-637): (embedding, logits), the distortion-
            # weighted cross-entropy on the logits
            out, logits = out
            id_loss = L.weighted_cross_entropy_loss(
                torch.softmax(logits, dim=-1), labels, distortions, epoch, self.num_epochs,
                sample_mask=mask)[0]
        fvs = out / (torch.linalg.vector_norm(out, dim=1, keepdim=True) + 1e-9)
        center_loss, aux = L.weighted_center_loss(
            fvs, labels, distortions, centers, epoch, self.num_epochs, tau=self.tau,
            sample_mask=mask)
        proxy_loss = L.weighted_proxy_loss(
            fvs, labels, distortions, proxies, proxy_labels, epoch, self.num_epochs,
            tau=self.tau, sample_mask=mask, p_max=self.num_proxies)
        total = center_loss + self.lambda_proxy * proxy_loss
        if id_loss is not None:
            total = total + id_loss
        if self.lambda_distortion > 0.0 and self.paired_batches:
            # adjacent [clean, distorted] slots (train_encodersKIT.py:382-394)
            total = total + self.lambda_distortion * L.paired_distortion_loss(
                fvs[0::2], fvs[1::2], distortions[1::2], epoch, self.num_epochs,
                pair_mask=mask[1::2])
        return torch.stack([total, center_loss, proxy_loss, aux["batch_acc_bal"],
                            aux["avg_max_prob"]])

    def forward_backward(self, images, labels, distortions, mask, centers, proxies,
                         proxy_labels, epoch, camids=None) -> torch.Tensor:
        """Forward and backward of one batch into the parameters' ``.grad``
        → (5,) f32 on the device: loss, center, proxy, balanced accuracy,
        mean max probability (valid-slot weighted over the chunks).
        ``camids`` (B,) are read by SIE models only. In a gang ``images``
        are this rank's block of the rows and the other arguments the
        global batch's."""
        self.optimizer.zero_grad(set_to_none=True)
        if camids is None:
            camids = torch.zeros_like(labels)
        n = self.grad_accum
        lo = self._rank * images.shape[0]
        if n == 1:
            m = self._losses(images, labels, distortions, mask, camids, centers, proxies,
                             proxy_labels, epoch, rows=slice(lo, lo + images.shape[0]))
            m[0].backward()
            self._sum_grads()
            return m.detach()
        dev = images.device
        local = torch.as_tensor(microbatch_slots(images.shape[0], n, self.paired_batches),
                                dtype=torch.long, device=dev)
        slots = torch.as_tensor(microbatch_slots(labels.shape[0], n, self.paired_batches),
                                dtype=torch.long, device=dev)
        m_sum = torch.zeros(5, dtype=torch.float32, device=dev)
        w_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for ls, sl in zip(local, slots):
            w_c = mask[sl].float().sum()  # valid slots
            m = self._losses(images[ls], labels[sl], distortions[sl], mask[sl], camids[sl],
                             centers, proxies, proxy_labels, epoch,
                             rows=slice(lo // n, (lo + images.shape[0]) // n))
            (w_c * m[0]).backward()
            m_sum += w_c * m.detach()
            w_sum += w_c
        self._sum_grads()
        denom = w_sum.clamp_min(1.0)
        with torch.no_grad():
            for p in self._params:
                if p.grad is not None:
                    p.grad.div_(denom)
        return m_sum / denom

    def _sum_grads(self) -> None:
        """Sum the gradients over the gang (one flat ``all_reduce``)."""
        if not active():
            return
        grads = [p.grad for p in self._params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce_(flat)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))

    @torch.no_grad()
    def apply_update(self) -> torch.Tensor:
        """Adam on the accumulated gradients, then the EMA → the weight-norm
        diagnostic ``sum p^2`` (``train_encodersKIT.py:229-233``)."""
        for p in self._params:
            if p.grad is None:
                # a parameter the loss does not reach (JPM's local heads under
                # a margin loss) still takes the decay step, as in optax;
                # torch's Adam would skip it
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        torch._foreach_mul_(self._ema_dst, self.beta)
        torch._foreach_add_(self._ema_dst, self._ema_src, alpha=1.0 - self.beta)
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(self._params))) ** 2

    def train_step(self, images_u8, labels, distortions, mask, centers, proxies, proxy_labels,
                   epoch, camids=None) -> torch.Tensor:
        """One optimizer step on a uint8 batch on the device → the step's
        metrics as a (6,) f32 device tensor, in the order of :data:`METRICS`."""
        images = self.augment(images_u8)
        m = self.forward_backward(images, labels, distortions, mask, centers, proxies,
                                  proxy_labels, epoch, camids)
        return torch.cat([m, self.apply_update()[None]])

    # ------------------------------------------------------------------
    # the epoch
    def set_epoch_hyperparams(self, epoch: int) -> float:
        """Per-epoch LR from the 3-phase schedule (``mainKIT.py:142-144``)."""
        lr = float(self._lr_values[min(epoch - 1, len(self._lr_values) - 1)])
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return lr

    def mine_proxies(self, verbose: bool = False, use_momentum: bool = False):
        """Whole-train-set re-embedding + per-class mining
        (``train_encodersKIT.py:103-156``), with the momentum model when
        ``use_momentum`` (``mainKIT.py:333-334``)."""
        extractor = self._mining_extractor or self.extractor
        extractor.update_variables((self.momentum if use_momentum else self.online).state_dict())
        with span("mine.extract", n=len(self.sampler.table)):
            # the table is fixed for the run: later minings reuse the decoded batches
            feats = extractor.extract(self.sampler.table, verbose=verbose, keep=True)
        class_idx = np.asarray(
            [self.sampler.label_to_class[l] for l in self.sampler.labels], np.int32)
        with span("mine.host", n=self.sampler.num_classes):
            pset = mine_proxies_and_centers(
                feats, class_idx, self.sampler.num_classes, self.num_proxies, self._rng)
        if verbose:
            print(f"Mean Max Proxies Positive Distances: {pset.mean_max_intra:.3f}, "
                  f"Min Negative Distance: {pset.min_inter:.3f}")
        return pset

    def _decode_batch(self, paths) -> np.ndarray:
        return decode_images(paths, *self.img_size, self.decode_workers)

    def _stage(self, batch):
        """Decode one batch into (pinned, on a GPU) host tensors; runs on the
        prefetch thread."""
        lo = self._rank * self._local_batch
        paths = batch.paths[lo:lo + self._local_batch]
        with span("train.decode", n=len(paths)):
            decoded = self._decode_batch(paths)
        images = torch.from_numpy(decoded)
        if self.device.type == "cuda":
            images = images.pin_memory()
        return (images, torch.from_numpy(batch.labels).long(),
                torch.from_numpy(batch.distortions).long(), torch.from_numpy(batch.mask),
                torch.from_numpy(batch.camids).long())

    def staged_batches(self, batches):
        """Yield each batch's tensors on the device while a prefetch thread
        decodes the next batch; its spans are children of the span open here."""
        with cf.ThreadPoolExecutor(1, initializer=adopt_span,
                                   initargs=(current_span(),)) as prefetcher:
            upcoming = prefetcher.submit(self._stage, batches[0]) if batches else None
            for i in range(len(batches)):
                current = upcoming
                if i + 1 < len(batches):
                    upcoming = prefetcher.submit(self._stage, batches[i + 1])
                with span("train.prefetch_wait"):
                    staged = current.result()
                yield [t.to(self.device, non_blocking=True) for t in staged]

    def train_epoch(self, epoch: int, verbose: bool = False) -> Dict[str, float]:
        """One pipeline iteration: mine proxies, run all PK batches."""
        lr = self.set_epoch_hyperparams(epoch)
        with self.timer.span("proxy_mining"):
            pset = self.mine_proxies(verbose=verbose,
                                     use_momentum=self.momentum_on_feature_extraction)
        put = lambda a: torch.as_tensor(a, device=self.device)
        centers, proxies = put(pset.centers), put(pset.proxies)
        proxy_labels = put(pset.proxy_labels).long()
        t0 = time.time()
        # the reference re-iterates the same loader num_iter times per epoch
        # between minings (train_encodersKIT.py:161)
        batches = [b for _ in range(self.num_iter) for b in self.sampler.epoch()]
        step_metrics = []
        with self.timer.span("finetuning"):
            for images_u8, labels, distortions, mask, camids in self.staged_batches(batches):
                with span("train.step", n=images_u8.shape[0]):
                    step_metrics.append(self.train_step(images_u8, labels, distortions, mask,
                                                        centers, proxies, proxy_labels, epoch,
                                                        camids))
            # one host sync for the whole epoch's diagnostics
            stacked = (torch.stack(step_metrics).cpu().double() if step_metrics
                       else torch.zeros((0, len(METRICS)), dtype=torch.float64))
        n = max(len(step_metrics), 1)
        means = {k: float(v) / n for k, v in zip(METRICS, stacked.sum(dim=0).tolist())}
        means["lr"] = lr
        means["epoch_seconds"] = time.time() - t0
        means["proxy_min_inter"] = pset.min_inter
        means["proxy_mean_max_intra"] = pset.mean_max_intra
        if verbose:
            print(f"Mean Center Loss: {means.get('center_loss', 0):.7f}, "
                  f"Mean Proxy Loss: {means.get('proxy_loss', 0):.7f}")
            print(f"Mean Final Loss: {means.get('loss', 0):.7f} ({len(step_metrics)} batches, "
                  f"lr={lr:g})")
        return means

    # ------------------------------------------------------------------
    # state: weights, optimizer and host RNG, for checkpoints
    def state_dict(self) -> dict:
        return {"online": self.online.state_dict(), "momentum": self.momentum.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.online.load_state_dict(state["online"], strict=True)
        self.momentum.load_state_dict(state["momentum"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])

    def rng_state(self) -> Dict[str, np.ndarray]:
        """All randomness as fixed-shape arrays: the augmentation and the
        drop-path Generators' states, the miner's and the sampler's PCG64
        streams."""
        return {
            "torch": self._gen.get_state().numpy(),
            "droppath": self._drop_gen.get_state().numpy(),
            "trainer": _encode_pcg64(self._rng),
            "sampler": _encode_pcg64(self.sampler._rng),
        }

    def set_rng_state(self, rng: Dict[str, np.ndarray]) -> None:
        self._gen.set_state(torch.from_numpy(np.asarray(rng["torch"], np.uint8)))
        if "droppath" in rng:  # absent from checkpoints of the ResNet-only trainer
            self._drop_gen.set_state(torch.from_numpy(np.asarray(rng["droppath"], np.uint8)))
        self._rng = _decode_pcg64(rng["trainer"])
        self.sampler._rng = _decode_pcg64(rng["sampler"])
