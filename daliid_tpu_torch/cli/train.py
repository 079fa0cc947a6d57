"""Training CLI on the GPU — port of ``daliid_tpu/cli/train.py``, the
reference's ``mainKIT.py`` training loop.

Flow of ``main`` (JAX ``:187-436``): build the (online, momentum) pair and
the PK sampler over the (merged) training tables; a pre-training eval; the
epoch loop with the 3-phase LR schedule; every ``--eval_freq`` epochs the
online and the momentum model are validated (CMC/mAP through kernel K2),
the best rank-1 is checkpointed with its weight files, and the progress
JSON is written; every ``--ckpt_freq`` epochs a crash-resume checkpoint goes
under ``<save_dir>/latest``. ``--resume`` restarts from the newer of the two
and replays the RNG stream. Flags are the JAX CLI's (``:36-145``) plus
``--device``, with its checks of the classifier, margin-head and SIE flags
(``:214-264``). ``--mining_quantize int8`` re-embeds the train set for
mining through a separate int8 extractor that recalibrates each epoch
(``--mining_calib_batches``); validation stays in full precision. With
``--dataset MSMT17`` (first of the list) each validation also prints the
balanced accuracy of the online model on MSMT17's ``val`` split (JAX
``:370-372``). The sampler names the turbulence copies by the first
dataset of ``--dataset`` (JAX ``:285``), for every merged table. A
multi-split first dataset (PRCC, VC-Clothes, ImageNet) is refused before
the first epoch when a validation would rank it, and so is a multi-head
model, whose tuple of embeddings the losses do not take. ``--remat``
(``models/vit.py::REMAT_MODES``) checkpoints the transformer blocks of the
``REMAT_MODELS`` and exits with the JAX CLI's error for any other model
(``:258-263``).

``--multihost`` (``--coordinator_address``, ``--num_processes``,
``--process_id``; JAX ``:441-446``) joins a gang (:mod:`daliid_tpu_torch.parallel`;
``cli/supervise.py`` launches one): each rank trains on its block of every
batch (``train/trainer.py``), validation ranks sharded, checkpoints pass a
barrier and rank 0 writes them, the weight files and the progress JSON.
``--fault_inject_epoch e`` is the drill hook of ``cli/supervise.py`` (JAX
``:403-422``): after epoch ``e``, before its crash-resume save, every rank
raises, or with ``--fault_inject_rank r`` rank ``r`` alone is SIGKILLed; a
``--resume`` run injects nothing.

Example::

    python -m daliid_tpu_torch train --dataset Synthetic --data_root /tmp/dd \\
        --model_name resnet50 --epochs 2 --P 4 --K 2 --eval_freq 1
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time

import torch

from daliid_tpu_torch.cli.common import check_camera_ids, refuse_multisplit
from daliid_tpu_torch.config import TrainConfig
from daliid_tpu_torch.data.registry import data_root, load_dataset, merge_train_tables
from daliid_tpu_torch.device import add_device_flag, parse_dtype, resolve_device
from daliid_tpu_torch.eval.validate import get_validator, msmt17_balanced_accuracy
from daliid_tpu_torch.models.factory import (
    MARGIN_HEAD_MODELS,
    MULTIHEAD_MODELS,
    REMAT_MODELS,
    SIE_MODELS,
    build_model_pair,
    check_model_name,
)
from daliid_tpu_torch.models.torch_port import load_state
from daliid_tpu_torch.models.vit import REMAT_MODES
from daliid_tpu_torch.parallel.distributed import (
    add_multihost_flags,
    maybe_initialize_from_args,
    shutdown_multihost,
)
from daliid_tpu_torch.parallel.mesh import rank
from daliid_tpu_torch.train.checkpoint import CheckpointManager, save_weights
from daliid_tpu_torch.train.sampler import PKBatchSampler
from daliid_tpu_torch.train.trainer import Trainer


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DaliID training (PyTorch/CUDA)")
    p.add_argument("--img_height", type=int, default=256)
    p.add_argument("--img_width", type=int, default=128)
    p.add_argument("--model_name", type=str, default="resnet50")
    p.add_argument("--model_path", type=str, default=None,
                   help="initial weights: JAX save_variables .npz or torch state_dict")
    p.add_argument("--lr", type=float, default=3.5e-4)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--P", type=int, default=16)
    p.add_argument("--K", type=int, default=12)
    p.add_argument("--tau", type=float, default=0.05)
    p.add_argument("--beta", type=float, default=0.999)
    p.add_argument("--lambda_proxy", type=float, default=0.4)
    p.add_argument("--epochs", "--number_of_epoches", dest="epochs", type=int, default=250)
    p.add_argument("--num_iter", type=int, default=1)
    p.add_argument("--momentum_on_feature_extraction", type=int, default=0)
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--turbulence_dir_path", type=str, default=None)
    p.add_argument("--is_clean_training", action="store_true")
    p.add_argument("--kind_of_transform", type=int, default=1)
    p.add_argument("--path_to_save_models", type=str, default="checkpoints")
    p.add_argument("--path_to_save_metrics", type=str, default="metrics")
    p.add_argument("--version", type=str, default="v0")
    p.add_argument("--eval_freq", type=int, default=5)
    p.add_argument("--ckpt_freq", type=int, default=1,
                   help="save a crash-resume checkpoint (full state + RNG) every N "
                        "epochs under <save_dir>/latest; 0 disables")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--extractor_batch", type=int, default=512)
    p.add_argument("--mining_quantize", type=str, default=None, choices=["int8"],
                   help="int8 PTQ for the per-epoch mining re-embedding "
                        "(train_encodersKIT.py:110 equivalent); validation extraction "
                        "stays full-precision. Recalibrates each epoch on the new "
                        "weights' first mining batches")
    p.add_argument("--mining_calib_batches", type=int, default=1)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer step: the batch is split into N "
                        "strided chunks (identities round-robin; AT pairs move as "
                        "units) whose grads combine weighted by valid-slot count before "
                        "one Adam update and one EMA update (BN stats thread through "
                        "the chunks). N must divide the batch (the pair count for "
                        "paired batches)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--skip_initial_eval", action="store_true")
    p.add_argument("--fault_inject_epoch", type=int, default=0,
                   help="drill hook for supervise: crash after this epoch, before its "
                        "crash-resume checkpoint (not on a --resume run); 0 = off")
    p.add_argument("--fault_inject_rank", type=int, default=-1,
                   help="with --fault_inject_epoch in a gang: SIGKILL only this rank (the "
                        "others block in their next collective); -1 = every rank raises")
    p.add_argument("--num_classes", type=int, default=0,
                   help="classifier head size for transreid_jpm and densenet121; "
                        "-1 = #train ids")
    p.add_argument("--id_loss_type", type=str, default="softmax",
                   choices=["softmax", "arcface", "cosface", "amsoftmax", "circle"],
                   help="ID-loss head (make_models.py:260-277 equivalents)")
    p.add_argument("--cosine_scale", type=float, default=None,
                   help="margin-head scale s (cfg.SOLVER.COSINE_SCALE; default per head)")
    p.add_argument("--cosine_margin", type=float, default=None,
                   help="margin-head margin m (cfg.SOLVER.COSINE_MARGIN; default per head)")
    p.add_argument("--sie_cameras", type=int, default=0,
                   help="SIE camera-embedding table for TransReID backbones; -1 = one "
                        "entry per training camera (cfg.MODEL.SIE_CAMERA)")
    p.add_argument("--sie_coef", type=float, default=1.5,
                   help="SIE embedding scale (sie_xishu; cfg.MODEL.SIE_COE)")
    p.add_argument("--remat", type=str, default="none", choices=REMAT_MODES,
                   help="transformer-family activation checkpointing (models/vit.py "
                        "REMAT_MODES): 'tuned' keeps qkv, the attention output and "
                        "norm2's output of each block, 'full' only block inputs; the same "
                        "values and gradients as 'none'")
    add_multihost_flags(p)
    add_device_flag(p)
    return p


def config_from_args(args) -> TrainConfig:
    return TrainConfig(
        model_name=args.model_name, img_height=args.img_height, img_width=args.img_width,
        compute_dtype=args.compute_dtype, model_path=args.model_path, dataset=args.dataset,
        data_root=args.data_root, turbulence_dir=args.turbulence_dir_path,
        kind_of_transform=args.kind_of_transform, is_clean_training=args.is_clean_training,
        P=args.P, K=args.K, lr=args.lr, weight_decay=args.weight_decay, tau=args.tau,
        beta=args.beta, lambda_proxy=args.lambda_proxy, num_epochs=args.epochs,
        eval_freq=args.eval_freq, ckpt_freq=args.ckpt_freq, save_dir=args.path_to_save_models,
        metrics_dir=args.path_to_save_metrics, version=args.version,
        extractor_batch=args.extractor_batch, grad_accum=args.grad_accum, device=args.device,
        mining_quantize=args.mining_quantize, mining_calib_batches=args.mining_calib_batches,
        num_classes=args.num_classes, id_loss_type=args.id_loss_type,
        margin_s=args.cosine_scale, margin_m=args.cosine_margin, sie_cameras=args.sie_cameras,
        sie_coef=args.sie_coef, remat=args.remat,
    )


def _head_kwargs(cfg: TrainConfig, train_table) -> dict:
    """The JAX CLI's checks of the head and SIE flags (``:214-257``) → the
    factory keywords (``num_classes`` and ``sie_cameras`` resolved from the
    training set)."""
    num_classes = cfg.num_classes if cfg.num_classes >= 0 else train_table.num_ids
    if cfg.id_loss_type != "softmax" and num_classes == 0:
        raise SystemExit(f"--id_loss_type {cfg.id_loss_type} needs a classifier head: "
                         "pass --num_classes (-1 = one class per training identity)")
    if cfg.id_loss_type == "softmax" and (cfg.margin_s is not None or cfg.margin_m is not None):
        raise SystemExit("--cosine_scale/--cosine_margin only apply with a margin "
                         "--id_loss_type (arcface/cosface/amsoftmax/circle)")
    if cfg.id_loss_type != "softmax" and cfg.model_name not in MARGIN_HEAD_MODELS:
        raise SystemExit(f"--id_loss_type {cfg.id_loss_type} is only supported by "
                         f"{sorted(MARGIN_HEAD_MODELS)} (make_models.py:262-289); "
                         f"{cfg.model_name} has no margin head")
    if cfg.sie_cameras and cfg.model_name not in SIE_MODELS:
        raise SystemExit(f"--sie_cameras only applies to {sorted(SIE_MODELS)}; "
                         f"{cfg.model_name} has no SIE embedding")
    if cfg.sie_coef != 1.5 and not cfg.sie_cameras:
        raise SystemExit("--sie_coef only takes effect with --sie_cameras != 0; "
                         "without SIE embeddings the coefficient is unused")
    sie_cameras = cfg.sie_cameras if cfg.sie_cameras >= 0 else int(train_table.camids.max()) + 1
    if sie_cameras:
        check_camera_ids(sie_cameras, [train_table], cfg.dataset)
    return dict(num_classes=num_classes, id_loss_type=cfg.id_loss_type, sie_cameras=sie_cameras,
                sie_coef=cfg.sie_coef, margin_s=cfg.margin_s, margin_m=cfg.margin_m)


def _inject_fault(epoch: int, target_rank: int) -> None:
    """The drill's crash (JAX ``:403-422``): SIGKILL ``target_rank`` (no
    cleanup: the others block until the supervisor tears them down), or, for
    -1, raise on every rank."""
    if target_rank >= 0:
        if rank() != target_rank:
            return
        print(f"fault injection: SIGKILL rank {rank()} after epoch {epoch} "
              f"(--fault_inject_rank)", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
    raise RuntimeError(f"fault injection: simulated crash after epoch {epoch} "
                       f"(--fault_inject_epoch)")


def main(args):
    """→ (best rank-1, its epoch)."""
    maybe_initialize_from_args(args)
    cfg = config_from_args(args)
    check_model_name(cfg.model_name)
    if cfg.remat != "none" and cfg.model_name not in REMAT_MODELS:
        raise SystemExit(f"--remat only applies to the transformer family "
                         f"{sorted(REMAT_MODELS)}; the CNN train step fits the card's memory at "
                         f"the protocol batch: drop the flag for {cfg.model_name!r}")
    if cfg.model_name in MULTIHEAD_MODELS:
        raise SystemExit(f"{cfg.model_name} returns a tuple of head embeddings and the "
                         "trainer's losses take one embedding (as the JAX trainer's do): "
                         "train a single-head model")
    device = resolve_device(cfg.device)
    dtype = parse_dtype(cfg.compute_dtype)
    print(f"Device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    # comma-separated datasets merge their training sets with densely
    # renumbered classes; evaluation uses the first target's query/gallery
    names = [n for n in cfg.dataset.split(",") if n]
    all_splits = [load_dataset(n, root=cfg.data_root) for n in names]
    splits = all_splits[0]
    train_table = merge_train_tables([s["train"] for s in all_splits])
    gallery, queries = splits["gallery"], splits["query"]
    if not args.skip_initial_eval or cfg.eval_freq <= cfg.num_epochs:
        refuse_multisplit(names[0], splits, "train's validation")
    print(f"Number of training examples: {len(train_table)} ({train_table.num_ids} ids)")

    online, momentum = build_model_pair(
        cfg.model_name, torch.Generator().manual_seed(cfg.seed), img_size=cfg.img_size,
        dtype=dtype, device=device, remat=cfg.remat, **_head_kwargs(cfg, train_table))
    if cfg.model_path:
        weights = load_state(cfg.model_name, cfg.model_path, online.module)
        online.module.load_state_dict(weights, strict=True)
        momentum.module.load_state_dict(weights, strict=True)
        print(f"Loaded weights from {cfg.model_path}")
    turbulence_dir = cfg.turbulence_dir
    if names[0] == "Synthetic" and cfg.kind_of_transform == 1 and not turbulence_dir:
        turbulence_dir = os.path.join(data_root(cfg.data_root), "Synthetic", "turbulence")

    sampler = PKBatchSampler(train_table, train_table.pids, P=cfg.P, K=cfg.K,
                             kind_of_transform=cfg.kind_of_transform,
                             turbulence_dir=turbulence_dir, dataset=names[0], seed=cfg.seed)
    trainer = Trainer(
        online, momentum, sampler, img_size=cfg.img_size, base_lr=cfg.lr,
        weight_decay=cfg.weight_decay, tau=cfg.tau, beta=cfg.beta,
        lambda_proxy=cfg.lambda_proxy, num_epochs=cfg.num_epochs,
        num_proxies=cfg.num_proxies, num_iter=args.num_iter,
        momentum_on_feature_extraction=bool(args.momentum_on_feature_extraction),
        compute_dtype=dtype, seed=cfg.seed, decode_workers=cfg.decode_workers,
        extractor_batch=cfg.extractor_batch, grad_accum=cfg.grad_accum,
        mining_quantize=cfg.mining_quantize, mining_calib_batches=cfg.mining_calib_batches,
    )

    writer = rank() == 0  # the weight files and the progress JSON
    if writer:
        os.makedirs(cfg.metrics_dir, exist_ok=True)
    ckpt = CheckpointManager(cfg.save_dir)
    # crash-resume channel: full state + RNG every ckpt_freq epochs, newest
    # kept (the best-metric manager only writes on new-best epochs)
    latest_ckpt = (CheckpointManager(os.path.join(cfg.save_dir, "latest"), max_to_keep=1,
                                     track_best=False) if cfg.ckpt_freq > 0 else None)
    start_epoch = 1
    best_r1, best_iter = 0.0, 0
    if args.resume:
        candidates = [(mgr.latest_step(), mgr) for mgr in (ckpt, latest_ckpt)
                      if mgr is not None and mgr.latest_step() is not None]
        if candidates:
            step, mgr = max(candidates, key=lambda c: c[0])
            state, last_epoch, rng = mgr.restore(epoch=step)
            trainer.load_state_dict(state)
            if rng is not None:
                trainer.set_rng_state(rng)
            start_epoch = last_epoch + 1
            # carry the best-R1 watermark across the restart
            best = ckpt.best_step()
            if best is not None:
                best_r1 = float(ckpt.metrics(best).get("rank1", 0.0))
                best_iter = int(best)
            print(f"Resumed from epoch {last_epoch} (best rank1 {best_r1:.4f} @ {best_iter})")

    validator = get_validator(names[0], img_size=cfg.img_size, batch_size=cfg.extractor_batch,
                              device=device)
    if not args.skip_initial_eval:
        # pre-training sanity eval (mainKIT.py:87)
        trainer.extractor.update_variables(trainer.online.state_dict())
        validator.validate(queries, gallery, trainer.extractor, verbose=True)

    progress = []
    t0_pipeline = time.time()
    for epoch in range(start_epoch, cfg.num_epochs + 1):
        print(f"###============ Iteration number {epoch}/{cfg.num_epochs} ============###")
        means = trainer.train_epoch(epoch, verbose=True)
        print(f"epoch {epoch}: loss={means.get('loss', 0):.5f} "
              f"center={means.get('center_loss', 0):.5f} proxy={means.get('proxy_loss', 0):.5f} "
              f"acc_bal={means.get('batch_acc_bal', 0):.3f} lr={means['lr']:g} "
              f"({means['epoch_seconds']:.1f}s)")

        if epoch % cfg.eval_freq == 0:
            trainer.extractor.update_variables(trainer.online.state_dict())
            cmc, mAP, _ = validator.validate(queries, gallery, trainer.extractor, verbose=True)
            trainer.extractor.update_variables(trainer.momentum.state_dict())
            cmc_m, mAP_m, _ = validator.validate(queries, gallery, trainer.extractor, verbose=True)
            if names[0] == "MSMT17" and "val" in splits:
                trainer.extractor.update_variables(trainer.online.state_dict())
                msmt17_balanced_accuracy(train_table, splits["val"], trainer.extractor)
            r1 = float(max(cmc[0], cmc_m[0]))
            if r1 > best_r1:
                best_r1, best_iter = r1, epoch
                ckpt.save(epoch, trainer.state_dict(), metrics={"rank1": r1, "mAP": float(mAP)},
                          rng=trainer.rng_state())
                for which, module in (("online", trainer.online), ("momentum", trainer.momentum)):
                    save_weights(os.path.join(
                        cfg.save_dir, f"model_{which}_{cfg.model_name}_{cfg.version}.pt"),
                        module.state_dict())
            progress.append({"epoch": epoch, "rank1": float(cmc[0]), "mAP": float(mAP),
                             "rank1_momentum": float(cmc_m[0]), "mAP_momentum": float(mAP_m),
                             **{k: float(v) for k, v in means.items()}})
            if writer:
                with open(os.path.join(cfg.metrics_dir,
                                       f"progress_{cfg.model_name}_{cfg.version}.json"), "w") as f:
                    json.dump(progress, f, indent=2)
            print(f"Best R1: {best_r1 * 100:.2f} and best iter: {best_iter}")

        if args.fault_inject_epoch and epoch == args.fault_inject_epoch and not args.resume:
            _inject_fault(epoch, args.fault_inject_rank)

        if latest_ckpt is not None and epoch % cfg.ckpt_freq == 0:
            latest_ckpt.save(epoch, trainer.state_dict(), rng=trainer.rng_state())

    total = time.time() - t0_pipeline
    # phase totals (the reference's accounting prints, mainKIT.py:193-201)
    print(trainer.timer.report())
    print(f"Total pipeline Time: {total:.1f}s "
          f"({total / max(cfg.num_epochs - start_epoch + 1, 1):.1f}s/epoch)")
    return best_r1, best_iter


if __name__ == "__main__":
    main(build_argparser().parse_args())
    shutdown_multihost()
