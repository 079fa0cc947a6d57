#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``daliid_tpu_torch``) on one GPU.

Phases, in order; any failed check exits non-zero and prints no result:

1. device: ``nvidia-smi`` name and power limit, the torch device name;
   build every ``daliid_tpu_torch/csrc/*.cu`` with nvcc (one process per
   source, in parallel) and print each kernel's registers, static shared
   memory and spills from ``-Xptxas=-v``; check that ``cuobjdump -sass`` of
   conv_int8's library shows warpgroup MMA (IGMMA) in every implicit-GEMM
   kernel; build the native JPEG loader
   (``g++``, libjpeg) and print which decoder the host path takes, with the
   compiler's message if the build failed; generate the synthetic set (100
   identities).
2. K2 ``rank_counts`` against its plain version on the card: random and
   tie-fuzzed distances, ragged and odd G, the evaluate path's shape, Q=64
   G=5,000 with P=4,096 all valid (many passes of sorted keys), rows whose
   every column is junk, rows whose every slot is invalid,
   ``ignore_camera`` both ways; counts must be equal.
3. K3 ``search_topk`` against its plain version on the card: SQ8 bit-exact,
   f32 values within 1e-5 relative with equal index sets; k in {1, 10, 64};
   num_real < G; the serve path's shape.
4. serve: ResNet-50 at 256x128, ``feature=both``, bf16, batch 64, seeded
   random weights; ``cli.serve.main`` in-process with ``--index_quantize
   int8``; enroll the gallery and search the query split by ``paths`` over
   TCP, check a search by ``embeddings`` against the plain index on the
   CPU, ``stats``, ``shutdown``. The SQ8 K3 counter must rise.
5. search: ``cli.search.main`` with the default f32 index. The f32 K3
   counter must rise.
6. evaluate: ``cli.evaluate.main`` on the same set. The K2 counter must
   rise; the CMC equals ``evaluate_rank_numpy`` on the same distance matrix
   exactly and mAP within 1e-12 (float64 summation order).
7. K1 ``fused_augment`` against its plain version on the card: random
   uint8 batches at the train shape (384, 256, 128, 3) and at (3, 32, 16)
   and (2, 37, 19), pad 10 and 4, and (2, 512, 256), whose bands overflow
   one stage of shared memory; crop offsets at 0 and 2*pad, erase
   rectangles touching each border; f32 within 2e-5, bf16 within one bf16
   ulp (or 2e-5 where that ulp is finer); two launches on the same inputs
   must give the same bits.
8. train: ``cli.train.main`` in-process: ResNet-50 at 256x128, bf16,
   ``--kind_of_transform 1``, P16 K12 (384 images a step), 2 epochs with
   ``--eval_freq 1`` on a synthetic set of 32 identities x 12 train images
   with turbulence copies (4 gallery, 2 query each). The K1 counter must
   equal the number of steps (4), the K2 counter must rise (validation), the
   epoch losses must be finite and the checkpoints written.
9. K4 ``flash_attention`` against its plain version on the card (f32 within
   2e-5, bf16 within one bf16 ulp, at the JPM, ViT-B and vit_small shapes
   and ragged small ones) and its backward (3e-5, f32).
9b. ``conv_int8`` against its plain version on the card (``quantize_sym``,
    then im2col and one float64 product, or the depthwise taps summed in
    int32: exact integer sums, no cuDNN) at the zoo's convolution shapes at
    batch 512, read from the models' forwards at 256x128: ResNet-50's 7x7/2
    stem (C = 3), a 1x1, a strided 3x3 and layer4's 3x3 at C = 512,
    DenseNet-121's 3x3 at C = 128, Inception-V3's 1x7 and 7x1, OSNet's
    depthwise 3x3 and EfficientNet-B0's depthwise 5x5/2, and small ragged
    cases (C = 5, C = 24 through both groups == 1 routes, a 3x3 whose input
    window exceeds shared memory, a depthwise C = 30); bf16 and f32 inputs
    (the kernel quantizes them in its loads; values over +-1.2 * 127 * s_in
    with exact half-way points planted) and int8 inputs; int32, f32 and bf16
    outputs, with and without bias, all bit-equal. Then the quantize alone
    on every bf16 value and every f32 bit pattern but NaN at three scales.
10. transformer evaluate: JPM and ViT-B through ``load_bundle(...,
    use_fused_attention=True)``, K4 16 and 12 launches a forward; the K4 and
    SDPA routes agree within 1e-3 in f32.
11. transformer train: a JPM ``Trainer`` epoch with K4, then the train CLI
    with ``--model_name transreid_jpm`` on SDPA.
12. evaluate-fusion: ``cli.evaluate_fusion.main`` on two ResNet-50
    checkpoints written from seeds 21 and 22 (bf16, 256x128), with the ROC
    dump: 7 rankings (concat, clean, distortion, average, magnitude under
    gap / gmp / both), K2 launched exactly 7 times, every CMC equal to the
    numpy oracle on the distmat it ranked and mAP within 1e-12.
13. evaluate-ensemble: ``cli.evaluate_ensemble.main`` over the seed-21
    ResNet-50 and a seeded ``resnet50IBN``: 3 rankings, K2 3 times.
14. multi-head evaluate: ``cli.evaluate.main --model_name
    multipart_resnet50 --multiple_output --mrfuse``: 4 heads, the ensemble
    and the meta-recognition fusion, K2 6 times, each against the oracle.
15. search past K3's cap: ``cli.search.main --topk 100`` launches no K3; an
    SQ8 index on the card answers k = 100 bit-exactly like the same index
    on the CPU; a serve batch (``IdentificationService``) mixing topk 100
    and topk 5 answers both like their own searches, and K3 runs only for
    the topk-5 search made alone.
16. the rest of the CNN zoo: ``cli.evaluate.main`` with each of ``osnet``,
    ``densenet121``, ``efficientnetB0`` and ``inceptionV3`` (bf16, 256x128,
    seeded random weights): K2 once each, each CMC equal to the numpy
    oracle.
17. ``cli.train.main --model_name densenet121 --num_classes -1``: the
    classifier-headed branch at the CLI's defaults (P16 K12 paired, tau
    0.05, lambda_proxy 0.4), one epoch of 2 steps and its validation: K1
    twice, K2 in the validation, finite losses, a checkpoint with one class
    per training identity.
18. ``cli.evaluate.main --rerank`` with ResNet-50: K2 once; the re-ranked
    distmat, computed on the card, equals the port's ``re_ranking`` on the
    CPU over the same three distance matrices within 1e-5.
19. ``cli.search.main --rerank --rerank_depth 64 --index_quantize int8``
    (the shortlist fetched by K3 SQ8 at k = 64), and a serve batch mixing
    re-ranked requests at depths 64 and 32 with plain topk 10 and 5: three
    dispatches, K3 once each, every answer like the same request alone.
19b. datasets and targets, on trees generated on the host (an MSMT17_V2
    tree of 32 train identities x 12 images with a val image each and 50
    test identities, whose train and gallery images have turbulence copies
    under MSMT17's pid-prefixed names only, so a wrong name fails to
    decode; a PRCC tree; BRIAR ``.npy`` manifests with close-range probes
    and probe-only identities), the counters reset before each step and
    read after it: ``cli.train.main --dataset MSMT17 --kind_of_transform
    1`` (ResNet-50, P16 K12, one epoch of 2 steps: K1 twice, K2 in the
    validation, the val split's balanced accuracy printed);
    ``cli.evaluate.main --targets MSMT17 --turbulence_dir_path ...
    --turbulence_strength 3`` (K2 once); ``--targets PRCC`` (3 query sets x
    10 gallery splits: K2 30 times); ``--targets BRIAR`` with the manifests
    (K2 once) and ``cli.evaluate_ensemble.main --dataset BRIAR`` (K2 3
    times); ``cli.search.main --dataset MSMT17`` (K3 f32); ``cli.stats.main``
    (its table: MSMT17, PRCC:g0-g9, PRCC:q0-q2). Every CMC equal to the
    numpy oracle.
20. multi-process runs on the one card (``daliid_tpu_torch/parallel``),
    each process started by this script with ``python3 chip_smoke.py
    --gang-child <spec>`` or ``python -m daliid_tpu_torch supervise``:
    20a. the crash drill: ``supervise --multihost 1`` over ``cli.train``
    (ResNet-50, P16 K12 paired, 3 epochs of 2 steps, ``--ckpt_freq 1``, no
    validation) on NCCL, once clean (beside ``supervise --multihost 0``
    with ``--fault_inject_epoch 2``: the process raises and resumes from
    epoch 1) and once with ``--fault_inject_epoch 2 --fault_inject_rank
    0``: the SIGKILL (rc -9), attempt 2, "Resumed from epoch 1", completion
    after 2 attempts; the epoch-1 checkpoint, copied when the rank died,
    through ``Trainer.load_state_dict`` and back equals itself bit for bit
    (RNG streams too); the stitched final state equal to the clean one bit
    for bit (parameters, BN statistics, Adam's state, RNG streams).
    20b. two ranks on the one card (gloo), one gang for all of: ``evaluate
    --multihost --sharded_eval`` in bf16 and with ``--quantize int8``,
    ``search`` at k = 10 on SQ8 and on f32, the first train step's summed
    gradient (before Adam), one ``train`` epoch of 2 steps at P16 K12 with
    its (sharded) validation, and the timed step. Each
    command's K1 / K2 / K3 / conv_int8 counts print on a line of their own,
    and each must rise on both ranks. The same commands in this process at
    half the batch (a rank's forward batch): every CMC equal, mAP within
    1e-12, search ids equal, SQ8 scores bit-exact, embeddings within cosine
    0.999 (int8 0.998), both ranks' answers equal; the first step's (f32)
    gradient within ``GRAD_L2_TOL`` in relative L2 norm of one process's
    and its BN running-statistics updates within ``BN_STEP_TOL`` of the
    largest of each (the floor, one process against itself with native BN
    kernels, printed beside it); after the bf16 epoch the parameters within
    Adam's reach of two steps, the BN running statistics within
    ``BN_EPOCH_TOL`` in relative L2 norm, Adam's step counts equal and its
    moments' norms within ``MOMENT_NORM_FACTOR``. A third process times the
    plain step and, after joining a 1-rank NCCL gang, holds the gang's
    fused BN (``models/norm.py::_GangBatchNorm``) against its eager version
    and against one process's cuDNN BN at ResNet-50's layer1 shape, forward
    and backward, and times all three and the gang's step; the 2-rank gang
    times
    its step and a gradient-sized (94 MB) all-reduce on gloo (a 1-rank
    NCCL all-reduce exchanges nothing, so NCCL's is not measurable on one
    card).
    20c. ``evaluate_rank_sharded`` on one process at MSMT17's protocol shape
    (Q 11,659, G 82,161, 2048-d rows of +-1 at 64 coordinates, so every
    distance is exact whatever the product's order) with ``query_chunk``
    512: K2 23 times, CMC equal to the replicated ``evaluate_rank`` on the
    whole distmat and mAP within 1e-12; time and peak memory of both; K2 at
    the chunk shape (512, 82,161) equal to its plain version.
21. the remainder (``phase_remainder``): 21a ``cli.train.main --model_name
    transreid_jpm --remat full --num_classes -1`` and ``--model_name vit
    --remat tuned``, one epoch of 2 steps at P16 K12 paired with its
    validation (SDPA; K1 twice and K2 each), and ``--remat full`` with
    ResNet-50 refused; 21b ``export`` of phase 8's ResNet-50 and phase 11's
    JPM checkpoints, .pt -> .npz -> .pth bit-equal to the .pt, ``evaluate``
    on the .npz with the .pt's CMC and mAP (K2 once each), and
    ``multipart_resnet50`` to a .pth refused by name; 21c ``mine_subset`` of
    the train set's first row with ResNet-50 and JPM on K4 (the row itself
    first, K4 16 times a JPM forward); 21d every loss of the library that
    no train step takes and ``margin_softmax_loss`` for the four heads at a
    PK batch of 384 x 2048 on the card against the same call on the CPU
    (values within 1e-5 relative, gradients within rtol 1e-4 plus 1e-6 of
    the largest entry). The remat step itself is timed with the JPM step
    (23): under ``none`` (twice), ``full`` and ``tuned`` on the same
    weights, batch and drop-path generator state, every gradient and the
    generator's state after it bit-equal to ``none``'s (cuDNN's
    deterministic algorithms on), K4 16 launches a forward and backward and
    32 under ``full``; then each mode's step ms, img/s and peak memory, and
    (21e) a ``profile_to`` trace of one ``tuned`` step whose file names the
    ``phase`` span around it.
22. int8 extraction, the float phases above having launched no conv_int8:
    ``cli.evaluate.main --quantize int8`` with ResNet-50 (K2 once,
    conv_int8 launched, the CMC equal to the oracle), again with
    ``--calib_batches 2 --batch_size 128``; 16 query images in f32 on the
    CPU's scales: each of the card's 53 int8 convolutions equal to the plain
    version on its own input, the embeddings against the CPU's int8 path
    (cosine >= 0.998, max |diff| <= 5e-2 of the largest entry; cosines with
    the f32 and bf16 embeddings printed); ``cli.search.main --quantize int8``
    and a serve daemon with ``--quantize int8 --index_quantize int8``
    (enroll and search by path); ``evaluate-fusion`` and
    ``evaluate-ensemble --quantize int8`` (12 and 2 calibrations, K2 7 and
    3); ViT-B with K4 and an int8 extractor (K4 12 a forward, the float
    calibration forward included, conv_int8 once a forward for the patch
    embedding, 48 ``torch._int_mm`` Dense layers a forward); ``cli.train.main
    --mining_quantize int8``, one epoch of 2 steps (K1 twice, conv_int8 in
    mining and not in the two validations, finite losses).
23. timings with CUDA events after warm-up: K3 SQ8 and f32 at Q=64,
    D=2048, k=10 over 2^20 gallery rows (the f32 bound is the tensor
    cores': bytes, or 3 TF32 products a multiply-add), and at the serve
    path's shape; K2 at the Market-1501 protocol shape (Q=3368, G=15913) at
    P=48, at the evaluate path's P (``queried_positives_bound``) and, kernel
    only, at ``max_positives_bound``'s P=2800, and at MSMT17's (Q=11659,
    G=82161, a 3.83 GB distmat) at P=64 and 256 with ``ignore_camera``
    both ways, each against its plain version (counts equal; the plain
    version timed once on the host clock); K1 at the train shape; K4 and SDPA at the
    JPM train shapes in bf16, with the attention backward (plain f32 torch)
    alone; one ResNet-50 train step split into augment, forward+backward and
    Adam+EMA, with img/s, peak device memory, the host decode time of one
    batch (with 1, 4 and the trainer's default number of threads) and the
    train loop's steady rate with decode on its prefetch thread
    (``PIPELINE_BATCHES`` steps, timed after the first batch has arrived),
    each with the native loader and with PIL
    and a ``torch.profiler`` view of three steps (the device's busy time,
    its share of the wall time, the largest kernels); ResNet-50 extraction
    img/s at batch 64 and 512 in bf16; the JPM train step and extraction at
    512 with K4 and with SDPA, the step under each remat mode (21a);
    ``magnitude_weighted_distmat`` and the 7
    rankings of evaluate-fusion at Market-1501's protocol shape; the four
    zoo families' extraction img/s and peak memory at batch 512; one
    ``densenet121`` train step (ms, img/s, peak memory); ``re_ranking`` at
    Market-1501's shape (ms, peak memory above its inputs); the re-ranked
    search of 200 probes over 400 SQ8 rows at depth 64; conv_int8 at each
    shape of 9b on the bf16 input (bf16 out) against its bound, its plain
    version, the ``quantize_sym`` + im2col + ``torch._int_mm`` route
    (groups = 1), cuDNN's bf16 convolution and itself on the int8 input; a
    ``torch.profiler`` pass over the int8 ResNet-50 forward at batch 512
    (conv_int8's device time against the rest; 53 launches; no
    ``aten::round`` / ``aten::clamp``); int8 against bf16 extraction at
    batch 512 (ResNet-50, the four zoo families, ViT-B with K4; peak
    memory).

Then one JSON line ``{"kernels": [...]}`` and, last, the device line
``{"ok": true, "device": {...}}``. Counts of launches are set to 0 just
before each of the serve, search, evaluate, train, transformer evaluate,
transformer train, fusion, ensemble, multi-head, k > 64 search, zoo
evaluate (each family), densenet train, re-ranked evaluate, re-ranked
search, each step of the datasets phase, each int8 phase, each command
of phase 20's processes (which print theirs) and each step of phase 21
and read just after.

Run from the repository root: ``python3 chip_smoke.py``. The kernels,
the synthetic sets, the saved index and the checkpoints go under ``build/``.
``python3 chip_smoke.py --compare <dir>`` instead times K2 (Market-like
table, P = 48, the evaluate path's P, ``max_positives_bound``'s P), K1
(the train shape, bf16), ``_QuantConv(conv, absmax)(x)`` on a bf16 batch
of 512 at each conv shape of 9b and the int8 ResNet-50 forward at batch 512
of this tree and of the tree unpacked at ``<dir>`` (for example the parent
commit's ``git archive``) on one card, in turns: parent, this, this,
parent.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"

# the serving configuration: ResNet-50 at its published input size
IMG = (256, 128)
# identities of the synthetic set (4 gallery and 2 query images each)
NUM_IDS = 100
COMPUTE_DTYPE = "bfloat16"
# the training run: P16 K12 paired (384 images a step) over 32 identities,
# 2 batches an epoch, 2 epochs
TRAIN_IDS, TRAIN_IMGS, P, K, EPOCHS = 32, 12, 16, 12, 2
TRAIN_STEPS = EPOCHS * (TRAIN_IDS // P)
# batches through the prefetching train loop for its steady rate (even: two an epoch)
PIPELINE_BATCHES = 10
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12,
            # K3's f32 mode on the tensor cores: three TF32 products a multiply-add
            # at 495 TFLOP/s (as much as its six bf16 piece products at 989)
            "tf32x3": 495e12 / 3}
# K4 against its plain version: TransReID-JPM's train shapes (the trunk and
# b1 at 211 tokens, the shared b2 at 1 + 52), ViT-B/16's 129 tokens at the
# extraction batch, vit_small's 96-wide heads, and ragged small cases
K4_SHAPES = [(384, 211, 12, 64), (384, 53, 12, 64), (512, 129, 12, 64), (64, 129, 8, 96),
             (3, 7, 2, 32), (2, 1, 1, 64), (5, 70, 3, 96)]
K4_TRAIN_SHAPES = K4_SHAPES[:2]
# K4 launches per forward: JPM's 11 trunk blocks, b1 and 4 x b2; ViT-B's 12 blocks
K4_PER_FORWARD = {"transreid_jpm": 16, "vit": 12}
EXTRACT_BATCH = 512


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean ms of ``fn()`` on the current stream over ``reps`` launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phase 1
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else "nvidia-smi unavailable"
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from daliid_tpu_torch.device import resolve_device
    from daliid_tpu_torch.ops import _build

    dev = resolve_device("cuda")
    t0 = time.time()
    libs = _build.build_all()
    log(f"built {sorted(libs)} in {time.time() - t0:.1f} s")
    ptxas = {name: ptxas_report(_build.build_log(name)) for name in sorted(libs)}
    for name, kernels in ptxas.items():
        for kernel, r in kernels.items():
            log(f"ptxas {name}: {kernel}: {r['registers']} registers, {r['static_smem']} bytes "
                f"static shared memory, spill stores {r['spill_stores']} / loads "
                f"{r['spill_loads']} bytes")
    check_warpgroup_mma(libs["conv_int8"])
    return card, dev, ptxas


def check_warpgroup_mma(lib) -> None:
    """conv_int8's implicit GEMM issues warpgroup MMA: the SASS of its
    library (``cuobjdump -sass``) holds IGMMA, Hopper's int8 ``wgmma``, in
    every conv_wgmma kernel."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    kernels, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernels[name] = 0
        elif name is not None and "IGMMA" in line:
            kernels[name] += 1
    gemm = {k: n for k, n in kernels.items() if "conv_wgmma" in k}
    check(len(gemm) > 0 and all(n > 0 for n in gemm.values()),
          f"cuobjdump -sass shows no IGMMA in some conv_wgmma kernel: {gemm}")
    log(f"cuobjdump -sass {Path(lib).name}: IGMMA in all {len(gemm)} conv_wgmma kernels "
        f"({sum(gemm.values())} instructions, {min(gemm.values())} to {max(gemm.values())} a "
        f"kernel)")


def ptxas_report(text: str) -> dict:
    """``nvcc -Xptxas=-v`` output → {kernel: registers, static shared
    memory and spill bytes}. Kernels of the anonymous namespace are named
    ``name<template arguments>`` (``topk_pass1<1>`` is SQ8,
    ``fused_augment_kernel<__nv_bfloat16>`` K1's bf16 output,
    ``conv_wgmma<__nv_bfloat16,256,0,2>`` conv_int8's gathering implicit
    GEMM at 256 output channels a tile, two consumer warpgroups); dynamic shared memory is set at launch
    and does not show here."""
    import re

    def name(mangled: str) -> str:
        # _ZN <length><namespace> <length><name> [I<template arguments>E] ...
        if not mangled.startswith("_ZN"):
            return mangled
        pos, last = 3, mangled
        while (m := re.match(r"\d+", mangled[pos:])):
            n = int(m.group())
            last = mangled[pos + m.end():pos + m.end() + n]
            pos += m.end() + n
        rest = mangled[pos:]
        if not rest.startswith("I"):
            return last
        # template arguments: f / i / a (float / int / int8_t), <length><name> (a class),
        # L<i|b><value>E (an int or bool value)
        args, i = [], 1
        while i < len(rest) and rest[i] != "E":
            if rest[i] in "fia":
                args.append({"f": "float", "i": "int", "a": "int8_t"}[rest[i]])
                i += 1
            elif (m := re.match(r"L[ib](\d+)E", rest[i:])):
                args.append(m.group(1))
                i += m.end()
            elif (m := re.match(r"\d+", rest[i:])):
                n = int(m.group())
                args.append(rest[i + m.end():i + m.end() + n])
                i += m.end() + n
            else:
                break
        return last + "<" + ",".join(args) + ">"

    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = name(m.group(1))
            out[current] = {"registers": None, "static_smem": 0, "spill_stores": None,
                            "spill_loads": None}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current]["spill_stores"], out[current]["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[current]["static_smem"] = int(s.group(1)) if s else 0
    return out


def make_dataset():
    from daliid_tpu_torch.data import load_dataset, make_synthetic_dataset

    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.time()
    # pre-generated under <root>/Synthetic, where the "Synthetic" target reads it
    make_synthetic_dataset(str(WORK / "data" / "Synthetic"), num_ids=NUM_IDS,
                           imgs_per_id_train=1, imgs_per_id_test=4, with_turbulence=False)
    splits = load_dataset("Synthetic", root=str(WORK / "data"))
    log(f"synthetic set: {NUM_IDS} identities, {len(splits['gallery'])} gallery, "
        f"{len(splits['query'])} query images in {time.time() - t0:.1f} s")
    return splits


# ---------------------------------------------------------------- phase 2
def _k2_inputs(torch, gen, dev, n_q, n_g, n_p, ties, n_ids=7, n_cams=3, keep=0.8,
               invalid_rows=False):
    """Random problem with P positive slots per query: distinct gallery
    columns, a ``keep`` share of the slots valid and the rest invalid (+inf
    / int32 max); with ``invalid_rows`` every slot of the even rows is
    invalid."""
    if ties:
        dist = torch.randint(0, 6, (n_q, n_g), generator=gen, device=dev).float() / 8.0
    else:
        dist = torch.rand((n_q, n_g), generator=gen, device=dev) * 2.0
    q_pids = torch.randint(0, n_ids, (n_q,), generator=gen, device=dev, dtype=torch.int32)
    q_cams = torch.randint(0, n_cams, (n_q,), generator=gen, device=dev, dtype=torch.int32)
    g_pids = torch.randint(0, n_ids, (n_g,), generator=gen, device=dev, dtype=torch.int32)
    g_cams = torch.randint(0, n_cams, (n_g,), generator=gen, device=dev, dtype=torch.int32)
    n_take = min(n_p, n_g)
    cols = torch.argsort(torch.rand((n_q, n_g), generator=gen, device=dev), dim=1)[:, :n_take]
    cols = torch.sort(cols, dim=1).values
    p_idx = torch.full((n_q, n_p), 2 ** 31 - 1, dtype=torch.int32, device=dev)
    p_dist = torch.full((n_q, n_p), float("inf"), device=dev)
    kept = torch.rand((n_q, n_take), generator=gen, device=dev) < keep
    if invalid_rows:
        kept[::2] = False
    p_idx[:, :n_take] = torch.where(kept, cols, 2 ** 31 - 1).int()
    p_dist[:, :n_take] = torch.where(kept, torch.gather(dist, 1, cols), float("inf"))
    return dist, p_dist, p_idx, q_pids, q_cams, g_pids, g_cams


def phase_k2(torch, dev, path_shape):
    from daliid_tpu_torch.ops.rank_counts import positive_rank_counts, rank_counts_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    # (Q, G, P, ties, extra): extra keywords of _k2_inputs
    cases = [
        (1, 1, 1, False, {}), (37, 211, 9, False, {}), (13, 57, 16, True, {}),
        (129, 1537, 33, True, {}), (300, 5000, 24, False, {}), (17, 513, 64, True, {}),
        (1000, 3000, 7, True, {}), (65, 10001, 40, False, {}),
        (*path_shape, False, {}), (*path_shape, True, {}),
        # more valid slots than one pass of sorted keys holds
        (64, 5000, 4096, False, {"keep": 1.0}), (8, 4099, 300, True, {"keep": 1.0}),
        # every column junk (one pid, one camera), every slot of half the rows invalid
        (40, 777, 16, True, {"n_ids": 1, "n_cams": 1}),
        (40, 777, 16, False, {"invalid_rows": True}),
    ]
    for n_q, n_g, n_p, ties, extra in cases:
        args = _k2_inputs(torch, gen, dev, n_q, n_g, n_p, ties, **extra)
        for ignore in (False, True):
            got = positive_rank_counts(*args, ignore_camera=ignore)
            want = rank_counts_plain(*args, ignore_camera=ignore)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"K2 counts differ at Q={n_q} G={n_g} P={n_p} ties={ties} {extra} "
                  f"ignore_camera={ignore}")
    log(f"K2 rank_counts == plain on {2 * len(cases)} cases (exact), "
        f"the evaluate path's (Q, G, P) = {path_shape} among them")


# ---------------------------------------------------------------- phase 3
def _k3_inputs(torch, gen, dev, n_q, n_g, d, dup):
    q8 = torch.randint(-127, 128, (n_q, d), generator=gen, device=dev, dtype=torch.int8)
    g8 = torch.randint(-127, 128, (n_g, d), generator=gen, device=dev, dtype=torch.int8)
    gs = (torch.rand((n_g,), generator=gen, device=dev) + 0.5) / 127.0
    qf = torch.nn.functional.normalize(torch.randn((n_q, d), generator=gen, device=dev), dim=1)
    gf = torch.nn.functional.normalize(torch.randn((n_g, d), generator=gen, device=dev), dim=1)
    if dup:  # bit-identical duplicate rows: exact ties that only the index order breaks
        g8[1::7] = g8[0::7][: g8[1::7].shape[0]]
        gs[1::7] = gs[0::7][: gs[1::7].shape[0]]
        gf[1::7] = gf[0::7][: gf[1::7].shape[0]]
    return q8, g8, gs, qf, gf


def k3_compare(torch, kernel_out, plain_out, quantized: bool, what: str) -> float:
    """Hold a K3 result against the plain version's; → max |value diff|."""
    (v, i), (vp, ip) = kernel_out, plain_out
    torch.cuda.synchronize()
    if quantized:
        check(torch.equal(v, vp) and torch.equal(i, ip), f"K3 SQ8 differs from plain at {what}")
        return 0.0
    real = ip >= 0
    check(torch.equal(i >= 0, real), f"K3 f32 filled slots differ at {what}")
    if not real.any():
        return 0.0
    rel = float(((v - vp).abs() / vp.abs().clamp_min(1e-30))[real].max())
    check(rel <= 1e-5, f"K3 f32 values off by {rel:.3g} relative at {what}")
    check(torch.equal(torch.sort(i, dim=1).values, torch.sort(ip, dim=1).values),
          f"K3 f32 index sets differ at {what}")
    return float((v - vp)[real].abs().max())


def phase_k3(torch, dev, path_shape):
    from daliid_tpu_torch.ops.search_topk import (
        f32_search_topk,
        search_topk_plain,
        sq8_search_topk,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    cases = [  # Q, G, D, num_real, duplicate rows
        (1, 64, 32, 64, False), (5, 1000, 99, 777, True), (64, 70000, 2048, 65537, True),
        (130, 4096, 2048, 4000, False), (3, 50, 16, 40, False), (7, 3000, 2, 2999, True),
        (*path_shape, True),
    ]
    worst = 0.0
    for n_q, n_g, d, nr, dup in cases:
        q8, g8, gs, qf, gf = _k3_inputs(torch, gen, dev, n_q, n_g, d, dup)
        for k in (1, 10, 64):
            what = f"Q={n_q} G={n_g} D={d} num_real={nr} k={k}"
            k3_compare(torch, sq8_search_topk(q8, g8, gs, nr, k),
                       search_topk_plain(q8, g8, nr, k, gs), True, what)
            worst = max(worst, k3_compare(
                torch, f32_search_topk(qf, gf, nr, k),
                search_topk_plain(qf, gf, nr, k),
                False, what))
    log(f"K3 search_topk == plain on {len(cases) * 3} cases (SQ8 bit-exact, f32 max |diff| "
        f"{worst:.3g}), the serve path's (Q, G, D, num_real) = {path_shape} among them")
    return worst


# ---------------------------------------------------------------- phase 4
class Client:
    def __init__(self, port: int, wait_s: float = 600.0):
        deadline = time.time() + wait_s
        while True:
            try:
                self.sock = socket.create_connection(("127.0.0.1", port), timeout=600)
                break
            except OSError:
                if time.time() > deadline:
                    fail(f"the daemon did not listen on port {port} within {wait_s} s")
                time.sleep(0.5)
        self.rfile = self.sock.makefile("r")

    def request(self, obj) -> dict:
        self.sock.sendall((json.dumps(obj) + "\n").encode())
        resp = json.loads(self.rfile.readline())
        check(resp.get("ok") is True, f"daemon answered {obj.get('op')} with {resp}")
        return resp

    def close(self):
        self.rfile.close()
        self.sock.close()


def _img_flags() -> list:
    return ["--img_height", str(IMG[0]), "--img_width", str(IMG[1])]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_serve(torch, splits, counts):
    import numpy as np

    from daliid_tpu_torch.cli import serve
    from daliid_tpu_torch.eval.matcher import GalleryIndex

    gallery, query = splits["gallery"], splits["query"]
    port = _free_port()
    args = serve.build_argparser().parse_args(
        ["--port", str(port), "--model_name", "resnet50", "--index_quantize", "int8",
         "--compute_dtype", COMPUTE_DTYPE, "--batch_size", "64", *_img_flags()])
    counts.reset()
    thread = threading.Thread(target=serve.main, args=(args,), daemon=True)
    t0 = time.time()
    thread.start()
    c = Client(port)
    log(f"serve: daemon listening after {time.time() - t0:.1f} s")
    check(c.request({"op": "stats"})["num_gallery"] == 0, "fresh daemon has a gallery")
    t1 = time.time()
    r = c.request({"op": "enroll", "paths": [str(p) for p in gallery.paths],
                   "pids": gallery.pids.tolist()})
    check(r["num_gallery"] == len(gallery), f"enrolled {r['num_gallery']} of {len(gallery)}")
    t2 = time.time()
    r = c.request({"op": "search", "paths": [str(p) for p in query.paths], "topk": 10})
    t3 = time.time()
    sims, idx, pids = (np.asarray(r[key]) for key in ("sims", "indices", "pids"))
    check(sims.shape == (len(query), 10) and np.isfinite(sims).all(),
          f"search by paths gave sims {sims.shape}")
    check(bool((np.diff(sims, axis=1) <= 0).all()), "search results are not in descending order")
    check(bool(((idx >= 0) & (idx < len(gallery))).all()), "search returned out-of-range rows")
    check(np.array_equal(pids, gallery.pids[idx]), "returned pids do not match the rows")
    top1 = float(np.mean(pids[:, 0] == query.pids))

    # the daemon's index against the plain index on the CPU: save it, search
    # its own rows by embeddings over the socket, and search the same rows on
    # the CPU (kernel K3 against its plain version on real embeddings)
    saved = str(WORK / "served_index.npz")
    c.request({"op": "save", "path": saved})
    with np.load(saved) as z:
        rows, row_pids = z["gallery"], z["pids"]
    # the saved rows are normalized already: commit them as they are (a load
    # normalizes again, which moves ulps and with them int8 roundings)
    reference = GalleryIndex.__new__(GalleryIndex)
    reference.quantize, reference.device, reference.gallery_pids = "int8", "cpu", row_pids
    reference._ranks = 1
    reference._commit(rows, normalized=True)
    probes = rows[:64]
    r = c.request({"op": "search", "embeddings": probes.tolist(), "topk": 10})
    v_ref, i_ref, p_ref = reference.search(probes, k=10)
    check(np.array_equal(np.asarray(r["indices"]), i_ref), "served search != plain index (rows)")
    check(np.array_equal(np.asarray(r["pids"]), p_ref), "served search != plain index (pids)")
    err = float(np.abs(np.asarray(r["sims"]) - v_ref).max())
    check(err <= 1e-6, f"served sims differ from the plain index's by {err}")  # 6-decimal protocol
    stats = c.request({"op": "stats"})
    c.request({"op": "shutdown"})
    c.close()
    thread.join(timeout=120)
    check(not thread.is_alive(), "the daemon did not shut down")
    launched = counts.read()
    check(launched["search_topk_sq8"] > 0, "the serve path did not launch K3 (SQ8)")
    log(f"serve: enroll {len(gallery)} paths {t2 - t1:.2f} s, search {len(query)} paths "
        f"{t3 - t2:.2f} s, top-1 identity accuracy {top1:.4f} (random weights), "
        f"busy_ms {stats['busy_ms']}, requests {stats['requests']}, "
        f"search dispatches {stats['search_dispatches']}, plain-index check |diff| {err:.3g}, "
        f"launches {launched}")
    return launched, top1


# ---------------------------------------------------------------- phase 5
def phase_search(torch, counts):
    import numpy as np

    from daliid_tpu_torch.cli import search

    args = search.build_argparser().parse_args(
        ["--dataset", "Synthetic", "--data_root", str(WORK / "data"), "--model_name", "resnet50",
         "--batch_size", "64", "--topk", "10", "--compute_dtype", COMPUTE_DTYPE, *_img_flags()])
    counts.reset()
    sims, ids, pids = search.main(args)
    launched = counts.read()
    check(np.isfinite(sims).all() and sims.shape[1] == 10, f"search CLI gave sims {sims.shape}")
    check(launched["search_topk_f32"] > 0, "the search CLI did not launch K3 (f32)")
    log(f"search CLI: launches {launched}")
    return launched


# ---------------------------------------------------------------- phase 6
def phase_evaluate(torch, counts):
    from daliid_tpu_torch.cli import evaluate

    args = evaluate.build_argparser().parse_args(
        ["--targets", "Synthetic", "--data_root", str(WORK / "data"), "--model_name", "resnet50",
         "--compute_dtype", COMPUTE_DTYPE, *_img_flags()])
    counts.reset()
    with RankRecorder() as rec:
        cmc, mAP = evaluate.main(args)["Synthetic"]
    launched = counts.read()
    check(launched["rank_counts"] > 0, "the evaluate path did not launch K2")
    err = rec.check_oracle("evaluate")
    log(f"evaluate: R1 {cmc[0]:.4f} mAP {mAP:.6f} (CMC equal to the numpy oracle, |mAP diff| "
        f"{err:.3g}), distmat {rec.calls[0][0].shape}, launches {launched}")
    return launched


# ---------------------------------------------------------------- phase 7
def bf16_ulp(torch, x):
    """One bf16 ulp at the magnitude of each element of ``x`` (f32)."""
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


def k1_compare(torch, got, want, dtype, what: str) -> float:
    """Hold a K1 output against the plain version's → max |diff|: f32
    within 2e-5; bf16 within one bf16 ulp of the larger magnitude, or 2e-5
    where that ulp is finer (near zero both round values that differ by the
    f32 tolerance)."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype == dtype,
          f"K1 output {tuple(got.shape)} {got.dtype} at {what}")
    check(got.is_contiguous(memory_format=torch.channels_last), f"K1 layout at {what}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    check(bool(torch.isfinite(g).all()), f"K1 output not finite at {what}")
    if dtype == torch.float32:
        tol = torch.full_like(diff, 2e-5)
    else:
        tol = torch.maximum(bf16_ulp(torch, torch.maximum(g.abs(), w.abs())),
                            torch.full_like(diff, 2e-5))
    bad = int((diff > tol).sum())
    check(bad == 0, f"K1 differs from plain at {what}: {bad} elements, max |diff| "
                    f"{float(diff.max()):.3g}")
    return float(diff.max())


def k1_edge_scalars(torch, table, h: int, w: int, pad: int):
    """Override a drawn (B, 16) table with the edge cases: crop offsets at 0
    and 2*pad, both flips, erase rectangles touching each border."""
    t = table.clone()
    b = t.shape[0]
    for i in range(b):
        oy, ox = (0, 2 * pad) if i % 2 else (2 * pad, 0)
        eh, ew = max(1, h // (2 + i % 3)), max(1, w // (2 + i % 2))
        ey, ex = [(0, 0), (h - eh, w - ew), (0, w - ew), (h - eh, 0)][i % 4]
        if i % 5 == 4:  # the whole width, the whole height
            ey, ex, eh, ew = 0, 0, h, w
        t[i, :10] = torch.tensor([oy, ox, i % 2, float(t[i, 3]), float(t[i, 4]),
                                  float(t[i, 5]), ey, ex, eh, ew], dtype=torch.float32)
    return t


def phase_k1(torch, dev):
    from daliid_tpu_torch.ops.fused_augment import draw_scalars, fused_augment, fused_augment_plain

    gen = torch.Generator().manual_seed(1)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    for (b, h, w), pad in [((384, 256, 128), 10), ((3, 32, 16), 10), ((3, 32, 16), 4),
                           ((2, 37, 19), 10), ((2, 37, 19), 4), ((5, 256, 128), 10),
                           ((2, 512, 256), 10)]:
        images = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8).to(dev)
        drawn = draw_scalars(b, h, w, pad, 0.4, 0.3, 0.4, (0.05, 0.30), (0.3, 3.3), gen)
        for edge in (False, True):
            scal = (k1_edge_scalars(torch, drawn, h, w, pad) if edge else drawn).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                what = f"B={b} H={h} W={w} pad={pad} edge={edge} {dtype}"
                got = fused_augment(images, scal, pad, dtype)
                worst[dtype] = max(worst[dtype], k1_compare(
                    torch, got, fused_augment_plain(images, scal, pad, dtype), dtype, what))
                again = fused_augment(images, scal, pad, dtype)
                torch.cuda.synchronize()
                check(torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                                  again.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)),
                      f"K1 differs between two launches at {what}")
                n_cases += 1
    log(f"K1 fused_augment == plain on {n_cases} cases (max |diff| f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}), the train path's "
        f"(384, 256, 128, 3) and the two-stage (2, 512, 256, 3) among them; two launches "
        f"give the same bits")
    return max(worst.values())


# ---------------------------------------------------------------- phase 8
def make_train_dataset():
    from daliid_tpu_torch.data import make_synthetic_dataset

    t0 = time.time()
    root = WORK / "train_data"
    make_synthetic_dataset(str(root / "Synthetic"), num_ids=TRAIN_IDS,
                           imgs_per_id_train=TRAIN_IMGS, imgs_per_id_test=4,
                           with_turbulence=True)
    log(f"train set: {TRAIN_IDS} identities x {TRAIN_IMGS} train images with turbulence "
        f"copies in {time.time() - t0:.1f} s")
    return root


def phase_train(torch, counts, root):
    import numpy as np

    from daliid_tpu_torch.cli import train

    ckpt, metrics = WORK / "train_ckpt", WORK / "train_metrics"
    args = train.build_argparser().parse_args(
        ["--dataset", "Synthetic", "--data_root", str(root), "--model_name", "resnet50",
         "--compute_dtype", COMPUTE_DTYPE, "--kind_of_transform", "1", "--P", str(P),
         "--K", str(K), "--epochs", str(EPOCHS), "--eval_freq", "1",
         "--path_to_save_models", str(ckpt), "--path_to_save_metrics", str(metrics),
         *_img_flags()])
    counts.reset()
    t0 = time.time()
    best_r1, best_iter = train.main(args)
    seconds = time.time() - t0
    launched = counts.read()
    check(launched["fused_augment"] == TRAIN_STEPS,
          f"the train path launched K1 {launched['fused_augment']} times for {TRAIN_STEPS} steps")
    check(launched["rank_counts"] > 0, "validation in the train path did not launch K2")
    progress = json.loads((metrics / "progress_resnet50_v0.json").read_text())
    check(len(progress) == EPOCHS, f"progress has {len(progress)} epochs, not {EPOCHS}")
    for row in progress:
        for key in ("loss", "center_loss", "proxy_loss", "rank1", "rank1_momentum"):
            check(np.isfinite(row[key]), f"epoch {row['epoch']}: {key} = {row[key]}")
    for name in ("model_online_resnet50_v0.pt", "model_momentum_resnet50_v0.pt",
                 "latest/index.json"):
        check((ckpt / name).exists(), f"the train run wrote no {name}")
    log(f"train: {TRAIN_STEPS} steps of {2 * P * K} images in {EPOCHS} epochs, "
        f"{seconds:.1f} s with mining and validation; losses "
        f"{[round(r['loss'], 5) for r in progress]}, rank-1 online "
        f"{[r['rank1'] for r in progress]} momentum {[r['rank1_momentum'] for r in progress]} "
        f"(random init), best {best_r1} @ {best_iter}; launches {launched}")
    return launched


# ---------------------------------------------------------------- phase 9: K4
def _qkv_views(torch, gen, dev, shape, dtype):
    """q, k, v as the (B, N, H, D) column blocks of one (B, N, 3*H*D)
    tensor, as the ViT's fused qkv projection hands them to K4."""
    b, n, h, d = shape
    qkv = torch.randn((b, n, 3 * h * d), generator=gen, device=dev).to(dtype)
    return [t.unflatten(-1, (h, d)) for t in qkv.split(h * d, dim=-1)]


def k4_compare(torch, got, want, dtype, what: str) -> float:
    """Hold a K4 output against the plain version's → max |diff|: f32 within
    2e-5; bf16 within one bf16 ulp of the larger magnitude, or 2e-5 where
    that ulp is finer (both round an f32 result once)."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype == dtype and got.is_contiguous(),
          f"K4 output {tuple(got.shape)} {got.dtype} at {what}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"K4 output not finite at {what}")
    diff = (g - w).abs()
    tol = torch.full_like(diff, 2e-5)
    if dtype == torch.bfloat16:
        tol = torch.maximum(bf16_ulp(torch, torch.maximum(g.abs(), w.abs())), tol)
    bad = int((diff > tol).sum())
    check(bad == 0, f"K4 differs from plain at {what}: {bad} elements, max |diff| "
                    f"{float(diff.max()):.3g}")
    return float(diff.max())


def phase_k4(torch, dev):
    """K4 against its plain version, forward in f32 and bf16 at every shape of
    ``K4_SHAPES``; the backward (the JAX VJP's, through the autograd
    Function) against autograd through the plain version at the JPM trunk's
    train shape in f32, within 3e-5. → (max |diff| forward, backward)."""
    from daliid_tpu_torch.ops.flash_attention import attention_plain, flash_attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in K4_SHAPES:
        for dtype in worst:
            q, k, v = _qkv_views(torch, gen, dev, shape, dtype)
            worst[dtype] = max(worst[dtype], k4_compare(
                torch, flash_attention(q, k, v), attention_plain(q, k, v), dtype,
                f"(B, N, H, D) = {shape} {dtype}"))
            del q, k, v
    shape = K4_TRAIN_SHAPES[0]
    q, k, v = (t.contiguous().requires_grad_() for t in
               _qkv_views(torch, gen, dev, shape, torch.float32))
    g_out = torch.randn(shape, generator=gen, device=dev)
    flash_attention(q, k, v).backward(g_out)
    kernel_grads = [t.grad for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    attention_plain(q, k, v).backward(g_out)
    torch.cuda.synchronize()
    bwd = max(float((a - t.grad).abs().max()) for a, t in zip(kernel_grads, (q, k, v)))
    check(bwd <= 3e-5, f"K4's backward differs from autograd through the plain version by {bwd}")
    del q, k, v, g_out, kernel_grads
    log(f"K4 flash_attention == plain on {2 * len(K4_SHAPES)} cases (max |diff| f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}), the JPM train shapes "
        f"among them; backward at {shape} f32 max |diff| {bwd:.3g}")
    return max(worst.values()), bwd


def set_fused_attention(module, on: bool) -> None:
    """Route every attention of ``module`` through K4 (``on``) or SDPA."""
    from daliid_tpu_torch.models.vit import Attention

    for m in module.modules():
        if isinstance(m, Attention):
            m.use_fused_attention = on


def _forwards(*tables) -> int:
    """Forward batches the extractor runs over these tables."""
    return sum(-(-len(t) // EXTRACT_BATCH) for t in tables)


# ---------------------------------------------------------------- phase 10
def phase_transformer_evaluate(torch, dev, splits, counts):
    """``load_bundle(model, None, (256, 128), bf16, cuda,
    use_fused_attention=True)`` → FeatureExtractor → the validator's distance
    matrix and K2 ranking, for ``transreid_jpm`` and ``vit``; K4 launched
    ``K4_PER_FORWARD`` times a forward batch; the CMC equal to the numpy
    oracle's; the K4 and SDPA routes agree in f32 on 32 query images."""
    import numpy as np

    from daliid_tpu_torch.cli.evaluate import load_bundle
    from daliid_tpu_torch.eval.features import FeatureExtractor
    from daliid_tpu_torch.eval.validate import get_validator
    from daliid_tpu_torch.metrics.ranking import evaluate_rank_numpy

    queries, gallery = splits["query"], splits["gallery"]
    validator = get_validator("Synthetic", img_size=IMG, batch_size=EXTRACT_BATCH, device=dev)
    total = {}
    for name, per_forward in K4_PER_FORWARD.items():
        bundle = load_bundle(name, None, IMG, torch.bfloat16, dev, use_fused_attention=True)
        extractor = FeatureExtractor(bundle, img_size=IMG, batch_size=EXTRACT_BATCH, device=dev)
        counts.reset()
        t0 = time.time()
        q_fvs, g_fvs = extractor.extract(queries), extractor.extract(gallery)
        distmat = validator.distance_matrix(q_fvs, g_fvs)
        cmc, mAP = validator.rank(distmat, queries, gallery)
        seconds = time.time() - t0
        launched = counts.read()
        forwards = _forwards(queries, gallery)
        check(launched["flash_attention"] == per_forward * forwards,
              f"{name}: K4 launched {launched['flash_attention']} times for {forwards} forwards")
        check(launched["rank_counts"] > 0, f"{name}: the evaluation did not launch K2")
        for fvs, table in ((q_fvs, queries), (g_fvs, gallery)):
            check(fvs.shape == (len(table), bundle.feature_dim) and np.isfinite(fvs).all(),
                  f"{name}: embeddings {fvs.shape}")
        cmc_n, map_n = evaluate_rank_numpy(distmat.cpu().numpy(), queries.pids, gallery.pids,
                                           queries.camids, gallery.camids,
                                           max_rank=validator.max_rank)
        check(np.array_equal(cmc, cmc_n) and abs(mAP - map_n) <= 1e-12,
              f"{name}: CMC/mAP differ from the numpy oracle")
        for k, n in launched.items():
            total[k] = total.get(k, 0) + n
        del extractor, bundle
        # the two attention routes on the same weights in f32 (TF32 off)
        f32 = load_bundle(name, None, IMG, torch.float32, dev, use_fused_attention=True)
        ex = FeatureExtractor(f32, img_size=IMG, batch_size=32, device=dev)
        images = ex._decode_paths([str(p) for p in queries.paths[:32]])
        k4 = ex.forward_batch(images)
        set_fused_attention(f32.module, False)
        sdpa = ex.forward_batch(images)
        rel = float((k4 - sdpa).abs().max() / sdpa.abs().max())
        check(rel <= 1e-3, f"{name}: K4 and SDPA routes differ by {rel:.3g} of the largest "
                           f"embedding entry in f32")
        log(f"transformer evaluate {name}: {len(queries)} query, {len(gallery)} gallery images, "
            f"{seconds:.2f} s, R1 {cmc[0]:.4f} mAP {mAP:.6f} (random weights; oracle R1 "
            f"{cmc_n[0]:.4f}), launches {launched}; f32 K4 vs SDPA route max |diff| "
            f"{rel:.3g} of the largest entry")
        del f32, ex
    return total


# ---------------------------------------------------------------- phase 11
def phase_transformer_train(torch, dev, root, counts):
    """``build_model_pair('transreid_jpm', num_classes=<train ids>,
    use_fused_attention=True)`` in bf16 and the port's Trainer at the JAX
    CLI's defaults (P16 K12 paired, tau 0.05, lambda_proxy 0.4): one epoch
    of 2 steps with mining, then a validation; then ``cli.train.main`` with
    ``--model_name transreid_jpm --num_classes -1`` for one epoch on the
    default attention (SDPA)."""
    import numpy as np

    from daliid_tpu_torch.cli import train
    from daliid_tpu_torch.data import load_dataset
    from daliid_tpu_torch.eval.validate import get_validator
    from daliid_tpu_torch.models import build_model_pair
    from daliid_tpu_torch.train.sampler import PKBatchSampler
    from daliid_tpu_torch.train.trainer import Trainer

    splits = load_dataset("Synthetic", root=str(root))
    table, queries, gallery = splits["train"], splits["query"], splits["gallery"]
    online, momentum = build_model_pair(
        "transreid_jpm", torch.Generator().manual_seed(12), img_size=IMG, dtype=torch.bfloat16,
        device=dev, num_classes=table.num_ids, use_fused_attention=True)
    sampler = PKBatchSampler(table, table.pids, P=P, K=K, kind_of_transform=1,
                             turbulence_dir=str(root / "Synthetic" / "turbulence"), seed=12)
    trainer = Trainer(online, momentum, sampler, img_size=IMG, tau=0.05, lambda_proxy=0.4,
                      compute_dtype=torch.bfloat16, extractor_batch=EXTRACT_BATCH)
    validator = get_validator("Synthetic", img_size=IMG, batch_size=EXTRACT_BATCH, device=dev)
    counts.reset()
    t0 = time.time()
    means = trainer.train_epoch(1, verbose=True)
    trainer.extractor.update_variables(trainer.online.state_dict())
    cmc, mAP, _ = validator.validate(queries, gallery, trainer.extractor, verbose=False)
    seconds = time.time() - t0
    launched = counts.read()
    steps = sampler.batches_per_epoch()
    forwards = steps + _forwards(table, queries, gallery)
    check(launched["fused_augment"] == steps,
          f"the JPM train path launched K1 {launched['fused_augment']} times for {steps} steps")
    check(launched["flash_attention"] == K4_PER_FORWARD["transreid_jpm"] * forwards,
          f"the JPM train path launched K4 {launched['flash_attention']} times for "
          f"{forwards} forwards")
    check(launched["rank_counts"] > 0, "the JPM validation did not launch K2")
    for key in ("loss", "center_loss", "proxy_loss"):
        check(np.isfinite(means[key]), f"JPM epoch {key} = {means[key]}")
    log(f"transformer train (JPM bf16, K4): {steps} steps of {2 * P * K} images with mining "
        f"and a validation in {seconds:.1f} s; loss {means['loss']:.5f} center "
        f"{means['center_loss']:.5f} proxy {means['proxy_loss']:.5f}, R1 {cmc[0]:.4f} (random "
        f"init); launches {launched}")
    del trainer, online, momentum

    ckpt, metrics = WORK / "jpm_ckpt", WORK / "jpm_metrics"
    args = train.build_argparser().parse_args(
        ["--dataset", "Synthetic", "--data_root", str(root), "--model_name", "transreid_jpm",
         "--num_classes", "-1", "--compute_dtype", COMPUTE_DTYPE, "--kind_of_transform", "1",
         "--P", str(P), "--K", str(K), "--epochs", "1", "--eval_freq", "1",
         "--skip_initial_eval", "--path_to_save_models", str(ckpt),
         "--path_to_save_metrics", str(metrics), *_img_flags()])
    counts.reset()
    t0 = time.time()
    train.main(args)
    seconds = time.time() - t0
    cli = counts.read()
    check(cli["fused_augment"] == steps and cli["rank_counts"] > 0,
          f"the JPM train CLI launched {cli}")
    progress = json.loads((metrics / "progress_transreid_jpm_v0.json").read_text())
    check(len(progress) == 1 and all(np.isfinite(progress[0][k]) for k in ("loss", "rank1")),
          f"JPM train CLI progress {progress}")
    log(f"transformer train CLI (JPM bf16, SDPA): 1 epoch of {steps} steps in {seconds:.1f} s, "
        f"loss {progress[0]['loss']:.5f}; launches {cli}")
    return {k: launched[k] + cli[k] for k in launched}


# ---------------------------------------------------------------- phases 12-15
class RankRecorder:
    """Records every ``evaluate_rank`` call of the validators (the distmat
    on the host, the id tables, the result) while it is active, so each
    ranking of a CLI is held against the numpy oracle afterwards."""

    def __init__(self):
        from daliid_tpu_torch.eval import validate

        self.validate, self.ranked, self.calls = validate, validate.evaluate_rank, []

    def __enter__(self):
        def rank(distmat, q_pids, g_pids, q_camids, g_camids, **kw):
            out = self.ranked(distmat, q_pids, g_pids, q_camids, g_camids, **kw)
            self.calls.append((distmat.cpu().numpy(), (q_pids, g_pids, q_camids, g_camids),
                               kw["max_rank"], out))
            return out

        self.validate.evaluate_rank = rank
        return self

    def __exit__(self, *exc):
        self.validate.evaluate_rank = self.ranked

    def check_oracle(self, what: str) -> float:
        """Every recorded CMC equal to ``evaluate_rank_numpy``'s on its
        distmat, mAP within 1e-12; → the largest |mAP diff|."""
        import numpy as np

        from daliid_tpu_torch.metrics.ranking import evaluate_rank_numpy

        worst = 0.0
        for i, (distmat, ids, max_rank, (cmc, mAP)) in enumerate(self.calls):
            check(np.isfinite(distmat).all(), f"{what}: ranking {i} has a non-finite distmat")
            cmc_n, map_n = evaluate_rank_numpy(distmat, *ids, max_rank=max_rank)
            check(np.array_equal(cmc, cmc_n), f"{what}: ranking {i} CMC != numpy oracle")
            check(abs(mAP - map_n) <= 1e-12, f"{what}: ranking {i} mAP {mAP} != oracle {map_n}")
            worst = max(worst, abs(mAP - map_n))
        return worst


def write_checkpoint(torch, name: str, seed: int) -> str:
    """A ``state_dict`` of ``name`` with weights from ``seed``, as a torch
    checkpoint the evaluate CLIs load."""
    from daliid_tpu_torch.models import get_model

    module = get_model(name, torch.Generator().manual_seed(seed), img_size=IMG).module
    path = WORK / f"{name}_seed{seed}.pt"
    torch.save(module.state_dict(), path)
    return str(path)


def _eval_flags() -> list:
    return ["--data_root", str(WORK / "data"), "--compute_dtype", COMPUTE_DTYPE,
            "--batch_size", str(EXTRACT_BATCH), *_img_flags()]


def phase_fusion(torch, counts, extra=()):
    """``cli.evaluate_fusion.main`` (the paper's clean + distorted fusion) on
    two ResNet-50 checkpoints written from different seeds, with the ROC
    dump; 7 rankings, K2 once each, every CMC equal to the numpy oracle.
    ``extra`` flags are added (``--quantize int8``)."""
    import numpy as np

    from daliid_tpu_torch.cli import evaluate_fusion

    clean, dist = write_checkpoint(torch, "resnet50", 21), write_checkpoint(torch, "resnet50", 22)
    args = evaluate_fusion.build_argparser().parse_args(
        ["--dataset", "Synthetic", "--model_path_clean", clean, "--model_path_distortion", dist,
         "--roc_version", "chip_smoke", *_eval_flags(), *extra])
    cwd = os.getcwd()
    os.chdir(WORK)  # the ROC files go to the working directory
    counts.reset()
    t0 = time.time()
    try:
        with RankRecorder() as rec:
            results = evaluate_fusion.main(args)
    finally:
        os.chdir(cwd)
    seconds = time.time() - t0
    launched = counts.read()
    tags = ["concat", "clean", "distortion", "average", "magnitude_gap", "magnitude_gmp",
            "magnitude_both"]
    check(list(results) == tags, f"evaluate-fusion reported {list(results)}")
    check(launched["rank_counts"] == len(tags),
          f"evaluate-fusion launched K2 {launched['rank_counts']} times for {len(tags)} rankings")
    err = rec.check_oracle("evaluate-fusion")
    d_clean, d_dist = rec.calls[1][0], rec.calls[2][0]
    check(float(np.abs(d_clean - d_dist).max()) > 1e-3, "the two checkpoints rank alike")
    fpr = np.load(WORK / "FPR_chip_smoke.npy")
    tpr = np.load(WORK / "TPR_chip_smoke.npy")
    check(fpr[0] == tpr[0] == 0 and fpr[-1] == tpr[-1] == 1 and (np.diff(fpr) >= 0).all(),
          "the ROC dump is not a curve from (0, 0) to (1, 1)")
    log(f"evaluate-fusion{''.join(' ' + e for e in extra)}: {seconds:.2f} s, "
        + ", ".join(f"{t} R1 {r['rank1']:.4f} mAP {r['mAP']:.6f}" for t, r in results.items())
        + f"; every CMC equal to the numpy oracle (|mAP diff| <= {err:.3g}); ROC {fpr.size} "
          f"points; launches {launched}")
    return launched, seconds


def phase_ensemble(torch, counts, extra=()):
    """``cli.evaluate_ensemble.main`` over a ResNet-50 checkpoint and a
    seeded ``resnet50IBN``: 3 rankings through K2; ``extra`` flags added."""
    from daliid_tpu_torch.cli import evaluate_ensemble

    args = evaluate_ensemble.build_argparser().parse_args(
        ["--dataset", "Synthetic", "--model_name01", "resnet50", "--model_path01",
         write_checkpoint(torch, "resnet50", 21), "--model_name02", "resnet50IBN",
         *_eval_flags(), *extra])
    counts.reset()
    t0 = time.time()
    with RankRecorder() as rec:
        results = evaluate_ensemble.main(args)
    seconds = time.time() - t0
    launched = counts.read()
    check(list(results) == ["model01", "model02", "ensemble"],
          f"evaluate-ensemble reported {list(results)}")
    check(launched["rank_counts"] == 3, f"evaluate-ensemble launched K2 {launched}")
    err = rec.check_oracle("evaluate-ensemble")
    log(f"evaluate-ensemble (resnet50 + resnet50IBN){''.join(' ' + e for e in extra)}: "
        f"{seconds:.2f} s, "
        + ", ".join(f"{t} R1 {r['rank1']:.4f} mAP {r['mAP']:.6f}" for t, r in results.items())
        + f"; CMC equal to the numpy oracle (|mAP diff| <= {err:.3g}); launches {launched}")
    return launched, seconds


def phase_multihead(torch, counts):
    """``cli.evaluate.main --model_name multipart_resnet50 --multiple_output
    --mrfuse``: 4 heads, the ensemble and the meta-recognition fusion, K2
    once each."""
    import numpy as np

    from daliid_tpu_torch.cli import evaluate

    args = evaluate.build_argparser().parse_args(
        ["--targets", "Synthetic", "--model_name", "multipart_resnet50", "--multiple_output",
         "--mrfuse", *_eval_flags()])
    counts.reset()
    t0 = time.time()
    with RankRecorder() as rec:
        results = evaluate.main(args)
    seconds = time.time() - t0
    launched = counts.read()
    check(list(results) == ["Synthetic", "Synthetic:mrfuse"], f"evaluate reported {list(results)}")
    check(launched["rank_counts"] == 6,
          f"multipart --multiple_output --mrfuse launched K2 {launched['rank_counts']} times, "
          f"not 6 (4 heads, the ensemble, mrfuse)")
    err = rec.check_oracle("evaluate --multiple_output --mrfuse")
    check(all(np.isfinite(cmc).all() for _, _, _, (cmc, _) in rec.calls), "non-finite CMC")
    log(f"evaluate multipart_resnet50 --multiple_output --mrfuse: {seconds:.2f} s, "
        + ", ".join(f"R1 {cmc[0]:.4f} mAP {mAP:.6f}" for _, _, _, (cmc, mAP) in rec.calls)
        + f" (heads 0-3, ensemble, mrfuse); CMC equal to the numpy oracle (|mAP diff| <= "
          f"{err:.3g}); launches {launched}")
    return launched, seconds


def phase_search_k100(torch, dev, counts):
    """``search --topk 100`` (past K3's cap: the library route, K3 not
    launched), the SQ8 route at k = 100 bit-exact against the index on the
    CPU, and a serve batch mixing topk 100 and 5: both answered like their
    own searches, K3 launched only for the search with k <= 64."""
    import numpy as np

    from daliid_tpu_torch.cli import search, serve
    from daliid_tpu_torch.eval.matcher import GalleryIndex

    args = search.build_argparser().parse_args(
        ["--dataset", "Synthetic", "--data_root", str(WORK / "data"), "--model_name", "resnet50",
         "--batch_size", "64", "--topk", "100", "--compute_dtype", COMPUTE_DTYPE, *_img_flags()])
    counts.reset()
    sims, ids, pids = search.main(args)
    cli = counts.read()
    check(sims.shape[1] == 100 and np.isfinite(sims).all() and (np.diff(sims, axis=1) <= 0).all(),
          f"search --topk 100 gave sims {sims.shape}")
    check(cli["search_topk_f32"] == 0 and cli["search_topk_sq8"] == 0,
          f"search --topk 100 launched K3: {cli}")

    rng = np.random.default_rng(6)
    g = rng.normal(size=(400, 2048)).astype(np.float32)
    on_card = GalleryIndex(g, np.arange(400), quantize="int8", device=dev)
    on_cpu = GalleryIndex(g, np.arange(400), quantize="int8", device="cpu")
    probes = g[:64] + 0.1 * rng.normal(size=(64, 2048)).astype(np.float32)
    (v, i, _), (v_c, i_c, _) = on_card.search(probes, k=100), on_cpu.search(probes, k=100)
    check(np.array_equal(i, i_c) and np.array_equal(v, v_c),
          "SQ8 search at k = 100 on the card differs from the CPU index")

    service = serve.IdentificationService(None, None, index_quantize="int8", device=dev)
    check(service.handle({"op": "enroll", "embeddings": g.tolist(),
                          "pids": list(range(400))})["ok"], "enroll by embeddings failed")
    reqs = [{"op": "search", "embeddings": probes[:3].tolist(), "topk": 100},
            {"op": "search", "embeddings": probes[3:5].tolist(), "topk": 5}]
    counts.reset()
    alone = [service.handle(r) for r in reqs]
    alone_launches = counts.read()
    entries = [{"req": r, "event": threading.Event(), "result": None} for r in reqs]
    counts.reset()
    with service._lock:
        service._serve_search_batch(entries)
    mixed = counts.read()
    check(alone_launches["search_topk_sq8"] == 1 and mixed["search_topk_sq8"] == 0,
          f"K3 launches: alone {alone_launches}, mixed batch {mixed}")
    for e, a in zip(entries, alone):
        r = e["result"]
        check(r["ok"] and a["ok"] and r["indices"] == a["indices"] and r["pids"] == a["pids"]
              and np.abs(np.asarray(r["sims"]) - np.asarray(a["sims"])).max() <= 1e-6,
              f"the mixed batch answered {e['req']['topk']} unlike its own search")
    log(f"search --topk 100: sims {sims.shape}, K3 launches {cli}; SQ8 k=100 on the card == "
        f"CPU index (bit-exact); serve batch of topk 100 + 5: both answered like alone, K3 "
        f"launches alone {alone_launches['search_topk_sq8']}, mixed "
        f"{mixed['search_topk_sq8']}")
    return {k: cli[k] + alone_launches[k] + mixed[k] for k in cli}


# ---------------------------------------------------------------- phases 16-19
# the rest of the CNN zoo: name → embedding width
ZOO = {"osnet": 512, "densenet121": 2048, "efficientnetB0": 1280, "inceptionV3": 2048}


def phase_zoo_evaluate(torch, counts):
    """``cli.evaluate.main`` with each of ``osnet``, ``densenet121``,
    ``efficientnetB0`` and ``inceptionV3`` (bf16, 256x128, seeded random
    weights) on the 100-identity set: K2 once each, each CMC equal to the
    numpy oracle."""
    import numpy as np

    from daliid_tpu_torch.cli import evaluate

    total, walls = {}, {}
    for name in ZOO:
        args = evaluate.build_argparser().parse_args(
            ["--targets", "Synthetic", "--model_name", name, *_eval_flags()])
        counts.reset()
        t0 = time.time()
        with RankRecorder() as rec:
            cmc, mAP = evaluate.main(args)["Synthetic"]
        walls[name] = time.time() - t0
        launched = counts.read()
        check(launched["rank_counts"] == 1, f"evaluate {name} launched K2 {launched}")
        err = rec.check_oracle(f"evaluate {name}")
        check(np.isfinite(cmc).all() and len(rec.calls) == 1, f"evaluate {name}: CMC {cmc}")
        log(f"evaluate {name}: {walls[name]:.2f} s, R1 {cmc[0]:.4f} mAP {mAP:.6f} (random "
            f"weights), distmat {rec.calls[0][0].shape}, CMC equal to the numpy oracle (|mAP "
            f"diff| {err:.3g}), launches {launched}")
        for k, n in launched.items():
            total[k] = total.get(k, 0) + n
    return total, walls


def phase_densenet_train(torch, counts, root):
    """``cli.train.main --model_name densenet121 --num_classes -1``: the
    classifier-headed branch at the CLI's defaults (``--kind_of_transform
    1``, P16 K12 = 384 images a step, tau 0.05, lambda_proxy 0.4), one epoch
    of 2 steps and its validation: K1 once a step, K2 in the validation,
    finite losses, a checkpoint with the 32-way head."""
    import numpy as np

    from daliid_tpu_torch.cli import train
    from daliid_tpu_torch.models.torch_port import load_state

    ckpt, metrics = WORK / "densenet_ckpt", WORK / "densenet_metrics"
    args = train.build_argparser().parse_args(
        ["--dataset", "Synthetic", "--data_root", str(root), "--model_name", "densenet121",
         "--num_classes", "-1", "--compute_dtype", COMPUTE_DTYPE, "--kind_of_transform", "1",
         "--P", str(P), "--K", str(K), "--epochs", "1", "--eval_freq", "1",
         "--skip_initial_eval", "--path_to_save_models", str(ckpt),
         "--path_to_save_metrics", str(metrics), *_img_flags()])
    counts.reset()
    t0 = time.time()
    train.main(args)
    seconds = time.time() - t0
    launched = counts.read()
    steps = TRAIN_IDS // P
    check(launched["fused_augment"] == steps,
          f"the densenet121 train CLI launched K1 {launched['fused_augment']} times for "
          f"{steps} steps")
    check(launched["rank_counts"] > 0, "the densenet121 validation did not launch K2")
    progress = json.loads((metrics / "progress_densenet121_v0.json").read_text())
    check(len(progress) == 1, f"densenet121 progress {progress}")
    for key in ("loss", "center_loss", "proxy_loss", "rank1"):
        check(np.isfinite(progress[0][key]), f"densenet121 epoch {key} = {progress[0][key]}")
    head = load_state("densenet121", str(ckpt / "model_online_densenet121_v0.pt"))
    check(tuple(head["classification.weight"].shape) == (TRAIN_IDS, ZOO["densenet121"]),
          "the densenet121 checkpoint has no head of one class per training identity")
    log(f"train densenet121 --num_classes -1 (bf16, classifier branch): 1 epoch of {steps} "
        f"steps of {2 * P * K} images and a validation in {seconds:.1f} s, loss "
        f"{progress[0]['loss']:.5f} center {progress[0]['center_loss']:.5f} proxy "
        f"{progress[0]['proxy_loss']:.5f} R1 {progress[0]['rank1']:.4f} (random init); "
        f"launches {launched}")
    return launched, seconds


def phase_rerank_evaluate(torch, counts):
    """``cli.evaluate.main --rerank`` with ResNet-50: K2 once; the re-ranked
    distmat was computed on the card and equals the port's ``re_ranking``
    on the CPU over the same three distance matrices within 1e-5; the CMC
    equals the numpy oracle's."""
    import numpy as np

    from daliid_tpu_torch.cli import evaluate
    from daliid_tpu_torch.eval import validate
    from daliid_tpu_torch.eval.rerank import re_ranking

    args = evaluate.build_argparser().parse_args(
        ["--targets", "Synthetic", "--model_name", "resnet50", "--rerank", *_eval_flags()])
    seen, reranking = [], validate.re_ranking

    def recording(qg, qq, gg, **kw):
        out = reranking(qg, qq, gg, **kw)
        seen.append(([d.cpu() for d in (qg, qq, gg)], out.device.type, out.cpu()))
        return out

    validate.re_ranking = recording
    counts.reset()
    t0 = time.time()
    try:
        with RankRecorder() as rec:
            cmc, mAP = evaluate.main(args)["Synthetic"]
    finally:
        validate.re_ranking = reranking
    seconds = time.time() - t0
    launched = counts.read()
    check(launched["rank_counts"] == 1, f"evaluate --rerank launched K2 {launched}")
    check(len(seen) == 1 and seen[0][1] == "cuda", "evaluate --rerank did not re-rank on the card")
    inputs, _, on_card = seen[0]
    err = float((re_ranking(*inputs) - on_card).abs().max())
    check(err <= 1e-5, f"re-ranking on the card differs from the CPU's by {err}")
    map_err = rec.check_oracle("evaluate --rerank")
    check(np.array_equal(on_card.numpy(), rec.calls[0][0]),
          "evaluate --rerank ranked another distmat than the re-ranked one")
    log(f"evaluate --rerank (resnet50): {seconds:.2f} s, R1 {cmc[0]:.4f} mAP {mAP:.6f}; the "
        f"card's re-ranked distmat {tuple(on_card.shape)} against the CPU's max |diff| "
        f"{err:.3g}; CMC equal to the numpy oracle (|mAP diff| {map_err:.3g}); launches "
        f"{launched}")
    return launched, seconds


def phase_search_rerank(torch, dev, counts):
    """``search --rerank --rerank_depth 64 --index_quantize int8`` (the
    shortlist fetched by K3 SQ8 at k = 64), then a serve batch mixing
    re-ranked requests at depths 64 and 32 with plain topk 10 and 5: three
    dispatches, K3 once each, every answer like the same request alone."""
    import numpy as np

    from daliid_tpu_torch.cli import search, serve

    args = search.build_argparser().parse_args(
        ["--dataset", "Synthetic", "--data_root", str(WORK / "data"), "--model_name", "resnet50",
         "--batch_size", "64", "--topk", "10", "--rerank", "--rerank_depth", "64",
         "--index_quantize", "int8", "--compute_dtype", COMPUTE_DTYPE, *_img_flags()])
    counts.reset()
    sims, ids, pids = search.main(args)
    cli = counts.read()
    check(sims.shape[1] == 10 and np.isfinite(sims).all()
          and (np.diff(sims, axis=1) <= 1e-6).all(), f"search --rerank gave sims {sims.shape}")
    check(cli["search_topk_sq8"] == 1 and cli["search_topk_f32"] == 0,
          f"search --rerank --index_quantize int8 launched K3 {cli}")

    rng = np.random.default_rng(7)
    g = rng.normal(size=(400, 2048)).astype(np.float32)
    probes = g[:8] + 0.3 * rng.normal(size=(8, 2048)).astype(np.float32)
    service = serve.IdentificationService(None, None, index_quantize="int8", device=dev)
    check(service.handle({"op": "enroll", "embeddings": g.tolist(),
                          "pids": list(range(400))})["ok"], "enroll by embeddings failed")
    reqs = [{"op": "search", "embeddings": probes[:3].tolist(), "topk": 10, "rerank": True,
             "rerank_depth": 64},
            {"op": "search", "embeddings": probes[3:5].tolist(), "topk": 10, "rerank": True,
             "rerank_depth": 32},
            {"op": "search", "embeddings": probes[5:7].tolist(), "topk": 10},
            {"op": "search", "embeddings": probes[7:].tolist(), "topk": 5}]
    counts.reset()
    alone = [service.handle(r) for r in reqs]
    alone_launches = counts.read()
    entries = [{"req": r, "event": threading.Event(), "result": None} for r in reqs]
    before = service._counters["search_dispatches"]
    counts.reset()
    with service._lock:
        service._serve_search_batch(entries)
    mixed = counts.read()
    dispatches = service._counters["search_dispatches"] - before
    check(dispatches == 3 and mixed["search_topk_sq8"] == 3
          and alone_launches["search_topk_sq8"] == 4,
          f"mixed batch: {dispatches} dispatches, K3 {mixed}; alone K3 {alone_launches}")
    for e, a in zip(entries, alone):
        r = e["result"]
        check(r["ok"] and a["ok"] and r["indices"] == a["indices"] and r["pids"] == a["pids"]
              and np.abs(np.asarray(r["sims"]) - np.asarray(a["sims"])).max() <= 1e-6,
              f"the mixed batch answered {e['req']} unlike its own search")
    check(alone[0]["indices"][0][0] == 0, "the re-ranked search lost the probe's own row")
    log(f"search --rerank --rerank_depth 64 --index_quantize int8: sims {sims.shape}, K3 "
        f"launches {cli}; serve batch of re-ranked (depth 64, 32) and plain (topk 10, 5) "
        f"requests: {dispatches} dispatches, K3 {mixed['search_topk_sq8']} (alone "
        f"{alone_launches['search_topk_sq8']}), every answer like its own search")
    return {k: cli[k] + alone_launches[k] + mixed[k] for k in cli}


# ---------------------------------------------------------------- phase 19b: datasets
# the generated MSMT17_V2 tree: 32 train identities x 12 images (two P16 K12
# steps an epoch), one val image each, 50 test identities x 4 gallery and 2
# query images; every train and gallery image has its 5 turbulence copies,
# under MSMT17's pid-prefixed names only
MSMT17_TREE = dict(train_ids=TRAIN_IDS, imgs_per_train_id=TRAIN_IMGS, test_ids=50,
                   gallery_per_id=4, query_per_id=2)


class Tee:
    """Standard output copied into a buffer while active."""

    def __enter__(self):
        import io

        self.out, self.buf = sys.stdout, io.StringIO()
        sys.stdout = self
        return self

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def __exit__(self, *exc):
        sys.stdout = self.out


def make_target_data():
    """The MSMT17_V2 tree, a PRCC tree and BRIAR manifests under
    ``WORK/targets`` → (data root, MSMT17 turbulence dir, manifest paths)."""
    from daliid_tpu_torch.data.synthetic import (
        make_briar_manifests,
        make_msmt17_tree,
        make_prcc_tree,
    )

    t0 = time.time()
    root = WORK / "targets"
    turb = make_msmt17_tree(str(root), **MSMT17_TREE)
    make_prcc_tree(str(root), train_ids=8, test_ids=40, imgs_per_id=2)
    manifests = make_briar_manifests(str(root / "briar"), train_ids=8, test_ids=40)
    log(f"generated MSMT17_V2 ({MSMT17_TREE}), PRCC (40 test identities) and BRIAR manifests "
        f"(40 identities) in {time.time() - t0:.1f} s")
    return root, turb, manifests


def phase_datasets(torch, counts):
    """Datasets and targets at full ResNet-50 width, the counters reset
    before each step and read after it: ``train --dataset MSMT17
    --kind_of_transform 1`` (1 epoch of 2 steps on the pid-prefixed copies:
    K1 twice, K2 in the validation, the balanced accuracy printed);
    ``evaluate --targets MSMT17`` on the turbulence gallery at strength 3
    (K2 once); ``evaluate --targets PRCC`` (K2 30 times); ``evaluate
    --targets BRIAR`` and ``evaluate-ensemble --dataset BRIAR`` on the
    manifests (K2 once and 3 times); ``search --dataset MSMT17`` (K3);
    ``stats``. Every CMC is held against the numpy oracle."""
    import numpy as np

    from daliid_tpu_torch.cli import evaluate, evaluate_ensemble, search, stats, train

    root, turb, manifests = make_target_data()
    trio = ["--train_file_path", manifests["train"], "--queries_file_path",
            manifests["queries"], "--gallery_file_path", manifests["gallery"]]
    flags = ["--data_root", str(root), "--compute_dtype", COMPUTE_DTYPE, *_img_flags()]
    total, walls = {}, {}

    def step(name, run, k2=None):
        counts.reset()
        t0 = time.time()
        with RankRecorder() as rec:
            out = run()
        walls[name] = time.time() - t0
        launched = counts.read()
        if k2 is not None:
            check(launched["rank_counts"] == k2,
                  f"{name} launched K2 {launched['rank_counts']} times, not {k2}")
        err = rec.check_oracle(name)
        for k, n in launched.items():
            total[k] = total.get(k, 0) + n
        return out, launched, err, rec

    from daliid_tpu_torch.eval.validate import msmt17_balanced_accuracy

    ckpt, metrics = WORK / "msmt17_ckpt", WORK / "msmt17_metrics"
    accuracies = []

    def balanced(*a, **kw):
        accuracies.append(msmt17_balanced_accuracy(*a, **kw))
        return accuracies[-1]

    args = train.build_argparser().parse_args(
        ["--dataset", "MSMT17", "--turbulence_dir_path", turb, "--kind_of_transform", "1",
         "--P", str(P), "--K", str(K), "--epochs", "1", "--eval_freq", "1",
         "--skip_initial_eval", "--path_to_save_models", str(ckpt),
         "--path_to_save_metrics", str(metrics), *flags])
    train.msmt17_balanced_accuracy = balanced
    try:
        with Tee() as tee:
            _, launched, _, _ = step("train --dataset MSMT17", lambda: train.main(args))
    finally:
        train.msmt17_balanced_accuracy = msmt17_balanced_accuracy
    steps = TRAIN_IDS // P
    check(launched["fused_augment"] == steps,
          f"train --dataset MSMT17 launched K1 {launched['fused_augment']} times for {steps} "
          f"steps")
    check(launched["rank_counts"] > 0, "the MSMT17 validation did not launch K2")
    check(len(accuracies) == 1 and 0.0 <= accuracies[0] <= 1.0
          and f"Balanced Accuracy on Validation Set: {accuracies[0]:.3%}" in tee.buf.getvalue(),
          f"train --dataset MSMT17 printed no balanced accuracy ({accuracies})")
    progress = json.loads((metrics / "progress_resnet50_v0.json").read_text())
    check(all(np.isfinite(progress[0][k]) for k in ("loss", "center_loss", "proxy_loss")),
          f"train --dataset MSMT17 losses {progress}")
    log(f"train --dataset MSMT17 --kind_of_transform 1: {steps} steps of {2 * P * K} images on "
        f"the pid-prefixed turbulence copies and a validation in "
        f"{walls['train --dataset MSMT17']:.1f} s, loss {progress[0]['loss']:.5f}, balanced "
        f"accuracy on val {accuracies[0]:.4f} (random init); launches {launched}")

    args = evaluate.build_argparser().parse_args(
        ["--targets", "MSMT17", "--turbulence_dir_path", turb, "--turbulence_strength", "3",
         "--batch_size", str(EXTRACT_BATCH), *flags])
    res, launched, err, rec = step("evaluate --targets MSMT17 turbulence 3",
                                   lambda: evaluate.main(args), k2=1)
    cmc, mAP = res["MSMT17"]
    log(f"evaluate --targets MSMT17 --turbulence_strength 3: R1 {cmc[0]:.4f} mAP {mAP:.6f}, "
        f"distmat {rec.calls[0][0].shape} (CMC equal to the numpy oracle, |mAP diff| "
        f"{err:.3g}); launches {launched}")

    args = evaluate.build_argparser().parse_args(
        ["--targets", "PRCC", "--batch_size", str(EXTRACT_BATCH), *flags])
    res, launched, err, rec = step("evaluate --targets PRCC", lambda: evaluate.main(args), k2=30)
    check(list(res) == ["PRCC:q0", "PRCC:q1", "PRCC:q2"], f"evaluate PRCC reported {list(res)}")
    log("evaluate --targets PRCC (3 query sets x 10 gallery splits): "
        + ", ".join(f"{k} R1 {r1:.4f} mAP {m:.6f}" for k, (r1, m) in res.items())
        + f"; 30 CMCs equal to the numpy oracle (|mAP diff| <= {err:.3g}); launches {launched}")

    args = evaluate.build_argparser().parse_args(
        ["--targets", "BRIAR", *trio, "--batch_size", str(EXTRACT_BATCH), *flags])
    res, launched, err, rec = step("evaluate --targets BRIAR", lambda: evaluate.main(args), k2=1)
    cmc, mAP = res["BRIAR"]
    check(mAP > 0.0, "the BRIAR manifests ranked without a mAP (not the standard protocol)")
    log(f"evaluate --targets BRIAR (manifests): R1 {cmc[0]:.4f} mAP {mAP:.6f}, distmat "
        f"{rec.calls[0][0].shape} (CMC equal to the numpy oracle); launches {launched}")

    args = evaluate_ensemble.build_argparser().parse_args(
        ["--dataset", "BRIAR", *trio, "--model_name02", "resnet50IBN", "--batch_size",
         str(EXTRACT_BATCH), *flags])
    res, launched, err, _ = step("evaluate-ensemble --dataset BRIAR",
                                 lambda: evaluate_ensemble.main(args), k2=3)
    log("evaluate-ensemble --dataset BRIAR (resnet50 + resnet50IBN): "
        + ", ".join(f"{t} R1 {r['rank1']:.4f} mAP {r['mAP']:.6f}" for t, r in res.items())
        + f" (CMC equal to the numpy oracle); launches {launched}")

    args = search.build_argparser().parse_args(
        ["--dataset", "MSMT17", "--batch_size", "64", "--topk", "10", *flags])
    (sims, _, pids), launched, _, _ = step("search --dataset MSMT17", lambda: search.main(args))
    check(launched["search_topk_f32"] > 0 and np.isfinite(sims).all() and sims.shape[1] == 10,
          f"search --dataset MSMT17: sims {sims.shape}, launches {launched}")
    log(f"search --dataset MSMT17: sims {sims.shape}; launches {launched}")

    with Tee() as tee:
        table, launched, _, _ = step("stats", lambda: stats.main(
            ["--targets", "MSMT17", "PRCC", "--data_root", str(root)]))
    lines = table.splitlines()
    check(tee.buf.getvalue() == table + "\n" and lines[0].startswith("Dataset")
          and [ln.split()[0] for ln in lines[2:]]
          == ["MSMT17"] + [f"PRCC:g{i}" for i in range(10)] + [f"PRCC:q{i}" for i in range(3)],
          f"stats printed:\n{table}")
    return total, {f"datasets: {k}": v for k, v in walls.items()}


# ---------------------------------------------------------------- int8 extraction
# the zoo's convolutions that conv_int8 is checked and timed at, by model and
# module name: ResNet-50's stem (C = 3), a 1x1, a strided 3x3 and layer4's 3x3
# at C = 512; DenseNet-121's 3x3 at C = 128; Inception-V3's 1x7 and 7x1;
# OSNet's depthwise 3x3; EfficientNet-B0's first depthwise 5x5
CONV_LAYERS = [("resnet50", "conv1"), ("resnet50", "layer1.1.conv1"),
               ("resnet50", "layer2.0.conv2"), ("resnet50", "layer4.0.conv2"),
               ("densenet121", "model_base.denseblock1.denselayer1.conv2"),
               ("inceptionV3", "Mixed_6b.branch7x7_2.conv"),
               ("inceptionV3", "Mixed_6b.branch7x7_3.conv"),
               ("osnet", "conv2.0.conv2a.conv2"), ("efficientnetB0", "features.3.0.block.1.0")]
# the shape whose times stand in the kernels line
CONV_MAIN = ("resnet50", "layer4.0.conv2")
# small ragged cases beside them: C = 5 (the staged window, channels padded
# to 8), C = 24 (8-channel pieces that do not fill 16 bytes of int8, as in
# EfficientNet-B0) through both routes of groups == 1 (a strided 1x1 takes
# the gathering one), a 3x3 whose window does not fit in shared memory (the
# gathering route), and a depthwise C not a multiple of 8 (element loads)
RAGGED_CONVS = {
    ("ragged", "3x3 C=5"): {"C": 5, "H": 9, "W": 7, "O": 6, "kernel": (3, 3), "stride": (1, 1),
                            "padding": (1, 1), "groups": 1, "batch": 3},
    ("ragged", "1x7 C=24"): {"C": 24, "H": 9, "W": 8, "O": 40, "kernel": (1, 7),
                             "stride": (1, 1), "padding": (0, 3), "groups": 1, "batch": 3},
    ("ragged", "1x1 C=24"): {"C": 24, "H": 5, "W": 7, "O": 40, "kernel": (1, 1),
                             "stride": (1, 1), "padding": (0, 0), "groups": 1, "batch": 3},
    ("ragged", "1x1/2 C=24"): {"C": 24, "H": 9, "W": 7, "O": 40, "kernel": (1, 1),
                               "stride": (2, 2), "padding": (0, 0), "groups": 1, "batch": 3},
    ("ragged", "3x3 C=1024 wide"): {"C": 1024, "H": 4, "W": 64, "O": 64, "kernel": (3, 3),
                                    "stride": (1, 1), "padding": (1, 1), "groups": 1,
                                    "batch": 2},
    ("ragged", "depthwise 5x5/2 C=30"): {"C": 30, "H": 7, "W": 5, "O": 30, "kernel": (5, 5),
                                         "stride": (2, 2), "padding": (2, 2), "groups": 30,
                                         "batch": 3},
}


def conv_shapes(torch, dev) -> dict:
    """{(model, layer): geometry} of ``CONV_LAYERS``, read from each model's
    forward of one 256x128 image (the input's (C, H, W) at that layer)."""
    from daliid_tpu_torch.models import get_model
    from daliid_tpu_torch.ops.quantize import conv_config

    out = {}
    for model in dict.fromkeys(m for m, _ in CONV_LAYERS):
        module = get_model(model, torch.Generator().manual_seed(12), dtype=torch.bfloat16,
                           device=dev).module
        mods = dict(module.named_modules())
        hooks = []
        for m, name in CONV_LAYERS:
            if m != model:
                continue
            conv = mods[name]
            stride, padding, groups = conv_config(conv)

            def hook(_mod, inputs, key=(m, name), conv=conv, geo=(stride, padding, groups)):
                _, c, h, w = inputs[0].shape
                out[key] = {"C": c, "H": h, "W": w, "O": conv.out_channels,
                            "kernel": tuple(conv.kernel_size), "stride": geo[0],
                            "padding": geo[1], "groups": geo[2]}

            hooks.append(conv.register_forward_pre_hook(hook))
        with torch.inference_mode():
            module(torch.zeros((1, 3, *IMG), device=dev, dtype=torch.bfloat16))
        for h in hooks:
            h.remove()
        del module
    check(len(out) == len(CONV_LAYERS), f"conv shapes found for {sorted(out)} only")
    return out


def _conv_inputs(torch, dev, geo, batch: int, seed: int, dtype=None, s_in: float = 0.0123):
    """(x, wq, s_w, bias) at ``geo``: x int8 codes, or (``dtype`` bf16 or
    f32) values spread over +-1.2 * 127 * s_in, a third of them exact
    half-way points (k + 0.5) * s_in, channels_last."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kh, kw = geo["kernel"]
    shape = (batch, geo["C"], geo["H"], geo["W"])
    if dtype is None:
        x = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    else:
        s_t = torch.full((), s_in, dtype=torch.float32, device=dev)
        x = (torch.rand(shape, generator=gen, device=dev) * 2.4 - 1.2) * 127 * s_t
        flat = x.view(-1)
        n = flat.numel() // 3
        flat[:n] = (torch.randint(-128, 128, (n,), generator=gen, device=dev).float() + 0.5) * s_t
        x = x.to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    wq = torch.randint(-127, 128, (geo["O"], kh, kw, geo["C"] // geo["groups"]), generator=gen,
                       device=dev, dtype=torch.int8)
    s_w = (torch.rand((geo["O"],), generator=gen, device=dev) + 0.5) / 127.0 / 64
    bias = torch.randn((geo["O"],), generator=gen, device=dev)
    return x, wq, s_w, bias


def _geo_str(key, geo) -> str:
    kh, kw = geo["kernel"]
    return (f"{key[0]} {key[1]}: B={geo.get('batch', EXTRACT_BATCH)} C={geo['C']} "
            f"{geo['H']}x{geo['W']} "
            f"O={geo['O']} {kh}x{kw} stride {geo['stride']} padding {geo['padding']} "
            f"groups {geo['groups']}")


# scales of the exhaustive quantize check: a calibrated-looking one, one
# whose reciprocal is inexact, a power of two
QUANT_SCALES = (0.0123, 1.0 / 3.0, 2.0 ** -5)


def _check_quantize_exhaustive(torch, dev) -> None:
    """The kernel's quantize on every bf16 value and every f32 bit pattern
    (NaN aside: its code is not defined) against ``quantize_sym``, through a
    1x1 convolution with identity weights (int32 out: each output is the
    input's code), 2^28 values a launch."""
    from daliid_tpu_torch.ops.conv_int8 import conv_int8, quantize_sym

    eye = torch.eye(8, dtype=torch.int8, device=dev).view(8, 1, 1, 8)
    ones = torch.ones(8, device=dev)
    for s in QUANT_SCALES:
        s_t = torch.full((), s, dtype=torch.float32, device=dev)
        s = float(s_t)
        bf = torch.arange(-32768, 32768, device=dev, dtype=torch.int32).to(torch.int16).view(
            torch.bfloat16)
        got = conv_int8(bf.view(1, 8192, 1, 8).permute(0, 3, 1, 2), eye, 1, 0, 1, s, ones, None,
                        torch.int32).permute(0, 2, 3, 1).reshape(-1)
        keep = ~torch.isnan(bf.float())
        bad_bf = int((got[keep] != quantize_sym(bf, s_t).int()[keep]).sum())
        bad, chunk = 0, 1 << 28
        for i in range((1 << 32) // chunk):
            bits = torch.arange(i * chunk, (i + 1) * chunk, device=dev, dtype=torch.int64)
            flat = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32).view(
                torch.float32)
            del bits
            got = conv_int8(flat.view(1, 1 << 13, chunk >> 16, 8).permute(0, 3, 1, 2), eye, 1, 0,
                            1, s, ones, None, torch.int32).permute(0, 2, 3, 1).reshape(-1)
            keep = ~torch.isnan(flat)
            bad += int((got[keep] != quantize_sym(flat, s_t).int()[keep]).sum())
            del flat, got, keep
        check(bad == 0 and bad_bf == 0, f"conv_int8's quantize differs from quantize_sym at "
                                        f"s_in {s!r}: {bad_bf} bf16 and {bad} f32 values")
    log(f"conv_int8's quantize equals quantize_sym on all 65,536 bf16 values and all 2^32 f32 "
        f"bit patterns but NaN, at s_in {[float(torch.tensor(s)) for s in QUANT_SCALES]}")


def phase_conv_int8(torch, dev, shapes) -> float:
    """conv_int8 against its plain version at each of ``CONV_LAYERS``' shapes
    at batch 512 and at ``RAGGED_CONVS``, on bf16 and f32 inputs (the
    kernel's quantize against ``quantize_sym``, half-way points planted) and
    on int8 inputs: the int32 sum and the f32 and bf16 outputs, with and
    without bias, equal bit for bit. The plain sum is im2col and a float64
    product (or, depthwise, int32 taps), so every partial sum is an exact
    integer. Then the quantize alone, exhaustively."""
    from daliid_tpu_torch.ops.conv_int8 import (
        conv_int8,
        conv_int32_plain,
        dequantize_plain,
        kernel_plan,
        quantize_sym,
    )

    s_in = 0.0123
    s_t = torch.full((), s_in, dtype=torch.float32, device=dev)
    for i, (key, geo) in enumerate({**shapes, **RAGGED_CONVS}.items()):
        args = (geo["stride"], geo["padding"], geo["groups"])
        batch = geo.get("batch", EXTRACT_BATCH)
        plan = kernel_plan((batch, geo["C"], geo["H"], geo["W"]),
                           (geo["O"], *geo["kernel"], geo["C"] // geo["groups"]), *args)
        for dtype in (torch.bfloat16, torch.float32, None):
            x, wq, s_w, bias = _conv_inputs(torch, dev, geo, batch, seed=30 + i, dtype=dtype)
            acc = conv_int32_plain(x if dtype is None else quantize_sym(x, s_t), wq, *args)
            for out_dtype in (torch.int32, torch.float32, torch.bfloat16):
                for b in (None, bias):
                    got = conv_int8(x, wq, *args, s_in, s_w, b, out_dtype)
                    want = dequantize_plain(acc, s_in, s_w, b, out_dtype)
                    torch.cuda.synchronize(dev)
                    check(got.shape == want.shape and torch.equal(got, want),
                          f"conv_int8 differs from its plain version at {_geo_str(key, geo)}, "
                          f"{x.dtype} in, {out_dtype} out, bias {b is not None}: max |diff| "
                          f"{float((got.float() - want.float()).abs().max())}")
            del x, wq, acc
        log(f"conv_int8 {_geo_str(key, geo)} ({plan}): bf16, f32 and int8 in; int32, f32 and "
            f"bf16 out (bias on and off) equal to quantize_sym + the plain version")
    _check_quantize_exhaustive(torch, dev)
    return 0.0


def _int8_counts(counts) -> dict:
    from daliid_tpu_torch.ops.quantize import int8_matmul

    out = counts.read()
    out["int8_matmul"] = int8_matmul.calls
    return out


def _reset_int8(counts) -> None:
    from daliid_tpu_torch.ops.quantize import int8_matmul

    counts.reset()
    int8_matmul.calls = 0


def phase_evaluate_int8(torch, dev, splits, counts):
    """``cli.evaluate.main --quantize int8`` with ResNet-50 (bf16): K2 once,
    conv_int8 launched, the CMC equal to the numpy oracle; then the same with
    ``--calib_batches 2 --batch_size 128`` (the 200 queries are two
    batches). Then the first 16 query images in f32 on the card with the
    scales calibrated on the CPU: every one of the 53 convolutions of that
    forward equal bit for bit to the plain version applied to
    the input the layer received; and the embeddings against the port's CPU
    int8 path on the same images and scales: cosine >= 0.998 per image and
    max |diff| <= 5e-2 of the largest entry (each int8 path's cosine with its
    own f32 forward is about 0.9992 on these images). The f32 normalize, batch norms
    and poolings between the convolutions round differently on the card, a
    quantize can follow an ulp by one step (1/127 of its range), and such
    flips cascade through the 53 layers; each path's cosine with its own
    float forward is printed beside it."""
    from daliid_tpu_torch.cli import evaluate
    from daliid_tpu_torch.cli.evaluate import load_bundle
    from daliid_tpu_torch.eval.features import FeatureExtractor
    from daliid_tpu_torch.ops import quantize as q8
    from daliid_tpu_torch.ops.conv_int8 import conv_int8_plain

    total, walls = {}, {}
    for extra in (["--quantize", "int8"],
                  ["--quantize", "int8", "--calib_batches", "2", "--batch_size", "128"]):
        args = evaluate.build_argparser().parse_args(
            ["--targets", "Synthetic", "--model_name", "resnet50", *_eval_flags(), *extra])
        _reset_int8(counts)
        t0 = time.time()
        with RankRecorder() as rec:
            cmc, mAP = evaluate.main(args)["Synthetic"]
        tag = "evaluate " + " ".join(extra)
        walls[tag] = time.time() - t0
        launched = _int8_counts(counts)
        check(launched["rank_counts"] == 1, f"{tag} launched K2 {launched}")
        check(launched["conv_int8"] > 0, f"{tag} launched no conv_int8")
        err = rec.check_oracle(tag)
        log(f"{tag} (resnet50): {walls[tag]:.2f} s, R1 {cmc[0]:.4f} mAP {mAP:.6f} (random "
            f"weights), CMC equal to the numpy oracle (|mAP diff| {err:.3g}), launches "
            f"{launched}")
        for k, n in counts.read().items():
            total[k] = total.get(k, 0) + n

    queries = splits["query"]
    images = FeatureExtractor(load_bundle("resnet50", None, IMG, torch.float32, "cpu"),
                              img_size=IMG, batch_size=16, device="cpu")._decode_paths(
        [str(p) for p in queries.paths[:16]])
    cpu = FeatureExtractor(load_bundle("resnet50", None, IMG, torch.float32, "cpu"),
                           img_size=IMG, batch_size=16, device="cpu", quantize="int8")
    cpu.calibrate(images)
    want = cpu.forward_batch(images)
    card = FeatureExtractor(load_bundle("resnet50", None, IMG, torch.float32, dev),
                            img_size=IMG, batch_size=16, device=dev, quantize="int8")
    card.quant_scales = dict(cpu.quant_scales)
    card._finalize_calibration()
    mods = dict(card.bundle.module.named_modules())
    seen = []
    hooks = [mods[n].register_forward_hook(lambda _m, i, o, n=n: seen.append((n, i[0], o)))
             for n in card._plan]
    before = counts.read()["conv_int8"]
    got = card.forward_batch(images).cpu()
    for h in hooks:
        h.remove()
    check(counts.read()["conv_int8"] - before == 53 and len(seen) == 53, "the card's int8 "
          "ResNet-50 forward did not launch conv_int8 once for each of its 53 convolutions")
    for n, x, y in seen:
        layer = card._plan[n]
        ref = conv_int8_plain(q8.quantize_sym(x, layer.s_in_t), layer.wq, layer.stride,
                              layer.padding, layer.groups, layer.s_in, layer.s_w, layer.bias,
                              y.dtype)
        check(torch.equal(y, ref), f"int8 forward: layer {n} differs from the plain version "
                                   f"on its own input")
    del seen
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    rel = float((got - want).abs().max() / want.abs().max())
    check(bool((cos >= 0.998).all()) and rel <= 5e-2,
          f"the card's int8 embeddings differ from the CPU's: cosine min {float(cos.min())}, "
          f"max |diff| {rel:.3g} of the largest entry")
    card_fp = torch.nn.functional.cosine_similarity(
        got, FeatureExtractor(card.bundle, img_size=IMG, batch_size=16, device=dev)
        .forward_batch(images).cpu(), dim=1)
    cpu_fp = torch.nn.functional.cosine_similarity(
        want, FeatureExtractor(cpu.bundle, img_size=IMG, batch_size=16, device="cpu")
        .forward_batch(images), dim=1)
    bf16 = FeatureExtractor(load_bundle("resnet50", None, IMG, torch.bfloat16, dev),
                            img_size=IMG, batch_size=16, device=dev).forward_batch(images).cpu()
    cos_bf16 = torch.nn.functional.cosine_similarity(got, bf16, dim=1)
    log(f"int8 ResNet-50, 16 query images in f32 with the CPU's scales: the 53 convolutions "
        f"of the card's forward equal to the plain version on their own inputs; embeddings, "
        f"card against CPU: cosine min {float(cos.min()):.7f}, max |diff| {rel:.3g} of the "
        f"largest entry; int8 against f32 cosine min on the card {float(card_fp.min()):.7f}, "
        f"on the CPU {float(cpu_fp.min()):.7f}; against the card's bf16 embeddings "
        f"(information) min {float(cos_bf16.min()):.6f} mean {float(cos_bf16.mean()):.6f}")
    del cpu, card
    return total, walls


def phase_search_serve_int8(torch, splits, counts):
    """``cli.search.main --quantize int8`` (K3 f32 and conv_int8), then a
    serve daemon with ``--quantize int8 --index_quantize int8``: enroll the
    gallery by path (the first request calibrates), search the queries by
    path: K3 SQ8 and conv_int8 launched."""
    import numpy as np

    from daliid_tpu_torch.cli import search, serve

    args = search.build_argparser().parse_args(
        ["--dataset", "Synthetic", "--data_root", str(WORK / "data"), "--model_name", "resnet50",
         "--batch_size", "64", "--topk", "10", "--compute_dtype", COMPUTE_DTYPE,
         "--quantize", "int8", *_img_flags()])
    _reset_int8(counts)
    sims, _, pids = search.main(args)
    cli = counts.read()
    check(np.isfinite(sims).all() and sims.shape[1] == 10, f"search --quantize int8: {sims.shape}")
    check(cli["search_topk_f32"] > 0 and cli["conv_int8"] > 0,
          f"search --quantize int8 launched {cli}")
    top1_search = float(np.mean(pids[:, 0] == splits["query"].pids))

    gallery, query = splits["gallery"], splits["query"]
    port = _free_port()
    args = serve.build_argparser().parse_args(
        ["--port", str(port), "--model_name", "resnet50", "--index_quantize", "int8",
         "--quantize", "int8", "--compute_dtype", COMPUTE_DTYPE, "--batch_size", "64",
         *_img_flags()])
    counts.reset()
    thread = threading.Thread(target=serve.main, args=(args,), daemon=True)
    thread.start()
    c = Client(port)
    r = c.request({"op": "enroll", "paths": [str(p) for p in gallery.paths],
                   "pids": gallery.pids.tolist()})
    check(r["num_gallery"] == len(gallery), f"int8 serve enrolled {r['num_gallery']}")
    r = c.request({"op": "search", "paths": [str(p) for p in query.paths], "topk": 10})
    served = np.asarray(r["sims"])
    check(served.shape == (len(query), 10) and np.isfinite(served).all(),
          f"int8 serve search gave {served.shape}")
    top1_serve = float(np.mean(np.asarray(r["pids"])[:, 0] == query.pids))
    c.request({"op": "shutdown"})
    c.close()
    thread.join(timeout=120)
    check(not thread.is_alive(), "the int8 daemon did not shut down")
    daemon = counts.read()
    check(daemon["search_topk_sq8"] > 0 and daemon["conv_int8"] > 0,
          f"serve --quantize int8 launched {daemon}")
    log(f"search --quantize int8: top-1 {top1_search:.4f}, launches {cli}; serve --quantize "
        f"int8 --index_quantize int8: enroll and search by path, top-1 {top1_serve:.4f} (random "
        f"weights), launches {daemon}")
    return {k: cli[k] + daemon[k] for k in cli}


def phase_fusion_ensemble_int8(torch, counts):
    """``evaluate-fusion --quantize int8`` (one int8 extractor per model,
    pooling and split: 12 calibrations, each split one batch at 512) and
    ``evaluate-ensemble --quantize int8`` (one a model: 2); K2 as in their
    float phases (7 and 3), conv_int8 launched."""
    from daliid_tpu_torch.eval.features import FeatureExtractor

    finals = []
    finalize = FeatureExtractor._finalize_calibration

    def counting(self):
        finals.append(self.bundle.name)
        return finalize(self)

    FeatureExtractor._finalize_calibration = counting
    try:
        fusion, fusion_s = phase_fusion(torch, counts, ["--quantize", "int8"])
        n_fusion = len(finals)
        ensemble, ensemble_s = phase_ensemble(torch, counts, ["--quantize", "int8"])
    finally:
        FeatureExtractor._finalize_calibration = finalize
    check(n_fusion == 12 and len(finals) == 14,
          f"calibrations: fusion {n_fusion} (12 expected), ensemble {len(finals) - n_fusion} "
          f"(2 expected)")
    for tag, launched in (("evaluate-fusion", fusion), ("evaluate-ensemble", ensemble)):
        check(launched["conv_int8"] > 0, f"{tag} --quantize int8 launched no conv_int8")
    log(f"int8 calibrations: evaluate-fusion {n_fusion} (per model, pooling and split), "
        f"evaluate-ensemble {len(finals) - n_fusion} (per model)")
    return ({k: fusion[k] + ensemble[k] for k in fusion},
            {"evaluate-fusion --quantize int8": fusion_s,
             "evaluate-ensemble --quantize int8": ensemble_s})


def phase_vit_int8(torch, dev, splits, counts):
    """ViT-B (bf16, 256x128) through ``load_bundle(..., use_fused_attention=
    True)`` and an int8 FeatureExtractor, ranked by the validator: K4 12
    times a forward batch as in the float phase (the float calibration
    forward included), conv_int8 once a forward
    (the patch embedding), the 48 qkv / proj / fc1 / fc2 layers of a forward
    through ``torch._int_mm``, K2 once, the CMC equal to the numpy oracle."""
    import numpy as np

    from daliid_tpu_torch.cli.evaluate import load_bundle
    from daliid_tpu_torch.eval.features import FeatureExtractor
    from daliid_tpu_torch.eval.validate import get_validator

    queries, gallery = splits["query"], splits["gallery"]
    validator = get_validator("Synthetic", img_size=IMG, batch_size=EXTRACT_BATCH, device=dev)
    bundle = load_bundle("vit", None, IMG, torch.bfloat16, dev, use_fused_attention=True)
    extractor = FeatureExtractor(bundle, img_size=IMG, batch_size=EXTRACT_BATCH, device=dev,
                                 quantize="int8")
    _reset_int8(counts)
    t0 = time.time()
    with RankRecorder() as rec:
        q_fvs, g_fvs = extractor.extract(queries), extractor.extract(gallery)
        cmc, mAP = validator.rank(validator.distance_matrix(q_fvs, g_fvs), queries, gallery)
    seconds = time.time() - t0
    launched = _int8_counts(counts)
    forwards = _forwards(queries, gallery)
    # the calibration forward (float) runs the attention too
    check(launched["flash_attention"] == K4_PER_FORWARD["vit"] * (forwards + 1),
          f"vit int8: K4 launched {launched['flash_attention']} times for {forwards} forwards "
          f"and one calibration forward")
    check(launched["conv_int8"] == forwards,
          f"vit int8: conv_int8 launched {launched['conv_int8']} times for {forwards} forwards")
    check(launched["int8_matmul"] == 48 * forwards,
          f"vit int8: {launched['int8_matmul']} int8 matmuls for {forwards} forwards (48 each)")
    check(launched["rank_counts"] == 1, f"vit int8: K2 {launched}")
    check(np.isfinite(q_fvs).all() and np.isfinite(g_fvs).all(), "vit int8: embeddings")
    err = rec.check_oracle("vit int8")
    log(f"evaluate vit --quantize int8 (K4 on): {seconds:.2f} s, R1 {cmc[0]:.4f} mAP "
        f"{mAP:.6f} (random weights), CMC equal to the numpy oracle (|mAP diff| {err:.3g}), "
        f"{len(extractor.quant_scales)} calibrated layers, launches {launched}")
    del extractor, bundle
    return counts.read(), seconds


def phase_train_int8(torch, counts, root):
    """``cli.train.main --mining_quantize int8`` with ResNet-50, one epoch
    (2 steps) with its validation: K1 once a step, conv_int8 launched in
    mining and not in the validation (its counter read around
    ``Validator.validate``), finite losses."""
    import numpy as np

    from daliid_tpu_torch.cli import train
    from daliid_tpu_torch.eval import validate

    metrics = WORK / "train_int8_metrics"
    args = train.build_argparser().parse_args(
        ["--dataset", "Synthetic", "--data_root", str(root), "--model_name", "resnet50",
         "--compute_dtype", COMPUTE_DTYPE, "--kind_of_transform", "1", "--P", str(P),
         "--K", str(K), "--epochs", "1", "--eval_freq", "1", "--skip_initial_eval",
         "--mining_quantize", "int8", "--path_to_save_models", str(WORK / "train_int8_ckpt"),
         "--path_to_save_metrics", str(metrics), *_img_flags()])
    from daliid_tpu_torch.ops.conv_int8 import conv_int8

    in_validation = []
    validate_fn = validate.Validator.validate

    def counted(self, *a, **kw):
        before = conv_int8.launches
        out = validate_fn(self, *a, **kw)
        in_validation.append(conv_int8.launches - before)
        return out

    validate.Validator.validate = counted
    counts.reset()
    t0 = time.time()
    try:
        train.main(args)
    finally:
        validate.Validator.validate = validate_fn
    seconds = time.time() - t0
    launched = counts.read()
    steps = TRAIN_IDS // P
    check(launched["fused_augment"] == steps,
          f"train --mining_quantize int8 launched K1 {launched['fused_augment']} times for "
          f"{steps} steps")
    check(len(in_validation) == 2 and in_validation == [0, 0],
          f"the validations launched conv_int8 {in_validation} times")
    check(launched["conv_int8"] > 0, "int8 mining launched no conv_int8")
    check(launched["rank_counts"] > 0, "the validation did not launch K2")
    progress = json.loads((metrics / "progress_resnet50_v0.json").read_text())
    for key in ("loss", "center_loss", "proxy_loss", "rank1"):
        check(np.isfinite(progress[0][key]), f"int8 mining: {key} = {progress[0][key]}")
    log(f"train --mining_quantize int8: {steps} steps in {seconds:.1f} s with int8 mining and "
        f"two float validations (online, momentum; conv_int8 {in_validation}); loss "
        f"{progress[0]['loss']:.5f}; launches {launched}")
    return launched, seconds


def loader_status() -> dict:
    """Which decoder the port's host path takes, and why."""
    import ctypes.util

    from daliid_tpu_torch.data import native_loader

    t0 = time.time()
    ok = native_loader.native_loader_available()
    pillow = native_loader.pillow_libjpeg()
    status = {"native_loader": ok, "linked_libjpeg": native_loader.linked(),
              "build_s": time.time() - t0, "gxx": shutil.which("g++"),
              "system_libjpeg": ctypes.util.find_library("jpeg"),
              "system_jpeglib_h": os.path.exists("/usr/include/jpeglib.h"),
              "pillow_libjpeg": str(pillow) if pillow else None,
              "build_error": native_loader.build_error()}
    log(f"host decoder: {'native C++ loader' if ok else 'PIL'}; {json.dumps(status)}")
    return status


def _time_fusion_at_market(torch, dev):
    """``magnitude_weighted_distmat`` (CUDA events) and the 7 rankings of
    evaluate-fusion (host clock, each ending in its CMC on the host) at
    Market-1501's protocol shape."""
    from daliid_tpu_torch.eval.fusion import magnitude_weighted_distmat
    from daliid_tpu_torch.metrics.ranking import evaluate_rank

    dist_a, q_pids, g_pids, q_cams, g_cams = market_like(torch, dev, seed=5)
    dist_b = market_like(torch, dev, seed=6)[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    n_q, n_g = dist_a.shape
    mags = [torch.rand((n, 1), generator=gen, device=dev) + 0.5 for n in (n_q, n_g, n_q, n_g)]
    fused = magnitude_weighted_distmat(dist_a, dist_b, *mags)
    ms = cuda_ms(torch, lambda: magnitude_weighted_distmat(dist_a, dist_b, *mags), reps=20)
    bytes_ = 3 * 4 * n_q * n_g + 8 * (n_q + n_g)
    ids = (q_pids, g_pids, q_cams, g_cams)
    evaluate_rank(fused, *ids)  # warm
    torch.cuda.synchronize()
    t0 = time.time()
    for d in (dist_a, dist_b, fused, dist_a, fused, dist_b, fused):
        evaluate_rank(d, *ids)
    rank_s = (time.time() - t0) / 7
    out = {"shape": f"Q={n_q} G={n_g}", "magnitude_weighted_distmat_ms": ms,
           "magnitude_bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3,
           "ranking_ms_each": rank_s * 1e3, "seven_rankings_ms": 7 * rank_s * 1e3}
    log(f"fusion at Market-1501's shape (CUDA events; rankings host clock): {json.dumps(out)}")
    del dist_a, dist_b, fused
    return out


# ---------------------------------------------------------------- phase 12
def _time_k3(torch, dev, n_q: int, n_g: int, num_real: int, reps: int, plain_reps: int):
    """Time K3 SQ8 and f32 at (Q, G, D=2048, num_real, k=10) against the plain
    version and a library yardstick; → {kernel name: timing}."""
    from daliid_tpu_torch.ops.search_topk import (
        f32_search_topk,
        search_topk_plain,
        sq8_search_topk,
    )

    d, k = 2048, 10
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    q8 = torch.randint(-127, 128, (n_q, d), generator=gen, device=dev, dtype=torch.int8)
    g8 = torch.randint(-127, 128, (n_g, d), generator=gen, device=dev, dtype=torch.int8)
    gs = (torch.rand((n_g,), generator=gen, device=dev) + 0.5) / 127.0
    shape = f"Q={n_q} G={n_g} num_real={num_real} D={d} k={k}"
    ops = 2 * n_q * num_real * d
    timings = {}

    out = sq8_search_topk(q8, g8, gs, num_real, k)
    err = k3_compare(torch, out, search_topk_plain(q8, g8, num_real, k, gs), True, shape)
    ms = cuda_ms(torch, lambda: sq8_search_topk(q8, g8, gs, num_real, k), reps=reps)
    plain_ms = cuda_ms(torch, lambda: search_topk_plain(q8, g8, num_real, k, gs),
                       reps=plain_reps, warmup=1)
    lib_ms = _library_ms(torch, lambda: torch.topk(
        torch._int_mm(q8, g8[:num_real].T).float() * gs[:num_real], k, dim=1),
        "torch.topk(torch._int_mm(q8, g8.T).float() * g_scale)")
    bytes_ = num_real * d + 4 * num_real + n_q * d + 8 * n_q * k
    timings["search_topk_sq8"] = _timing(shape, ms, plain_ms, lib_ms, bytes_, ops, "int8", err)
    del g8, gs

    qf = torch.nn.functional.normalize(torch.randn((n_q, d), generator=gen, device=dev), dim=1)
    gf = torch.randn((n_g, d), generator=gen, device=dev)
    out = f32_search_topk(qf, gf, num_real, k)
    err = k3_compare(torch, out, search_topk_plain(qf, gf, num_real, k), False, shape)
    ms = cuda_ms(torch, lambda: f32_search_topk(qf, gf, num_real, k), reps=reps)
    plain_ms = cuda_ms(torch, lambda: search_topk_plain(qf, gf, num_real, k),
                       reps=plain_reps, warmup=1)
    lib_ms = _library_ms(torch, lambda: torch.topk(qf @ gf[:num_real].T, k, dim=1),
                         "torch.topk(q @ g.T)")
    bytes_ = 4 * num_real * d + 4 * n_q * d + 8 * n_q * k
    timings["search_topk_f32"] = _timing(shape, ms, plain_ms, lib_ms, bytes_, ops, "tf32x3", err)
    del gf
    return timings


def _library_ms(torch, fn, what: str):
    """Time a PyTorch yardstick; → ms, or None if this build refuses it."""
    try:
        ms = cuda_ms(torch, fn, reps=5)
    except (RuntimeError, NotImplementedError) as exc:
        log(f"library yardstick {what} not timed: {type(exc).__name__}: {exc}")
        return None
    log(f"library yardstick: {what}")
    return ms


def _timing(shape, ms, plain_ms, lib_ms, bytes_, ops, op_type, err):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_, "ops": ops, "max_abs_err": err}


def market_ids(seed: int = 5):
    """Market-1501's test protocol ids: 750 query identities, 13,115 gallery
    rows of those identities, 2,798 distractor rows of pid 0 (kept, as
    ``parse_market_duke_dir`` keeps them), 6 cameras, 3,368 queries →
    (q_pids, g_pids, q_cams, g_cams)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g_pids = np.concatenate([rng.integers(1, 751, 13115), np.zeros(2798, np.int64)])
    rng.shuffle(g_pids)
    g_cams = rng.integers(1, 7, g_pids.size)
    q_pids = rng.integers(1, 751, 3368)
    q_cams = rng.integers(1, 7, q_pids.size)
    return q_pids, g_pids, q_cams, g_cams


def market_like(torch, dev, seed: int = 5):
    """The ids of :func:`market_ids` and a (3368, 15913) distance matrix of
    uniform random distances."""
    q_pids, g_pids, q_cams, g_cams = market_ids(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dist = torch.rand((q_pids.size, g_pids.size), generator=gen, device=dev)
    return dist, q_pids, g_pids, q_cams, g_cams


def _time_k2(torch, dev, results):
    from daliid_tpu_torch.metrics.ranking import (
        _positive_prologue,
        max_positives_bound,
        positive_columns,
        queried_positives_bound,
    )
    from daliid_tpu_torch.ops.rank_counts import positive_rank_counts, rank_counts_plain

    dist, q_pids, g_pids, q_cams, g_cams = market_like(torch, dev)
    n_q, n_g = dist.shape
    ids = [torch.as_tensor(a, dtype=torch.int32, device=dev) for a in (q_pids, q_cams, g_pids, g_cams)]
    bound_p = max_positives_bound(g_pids)
    path_p = queried_positives_bound(q_pids, g_pids)
    log(f"K2 Market-like table: max_positives_bound = {bound_p} (distractor pid 0 kept), "
        f"the evaluate path's queried_positives_bound = {path_p}")
    # the P=48 row is the kernel's main entry, as in earlier runs
    for role, n_p, with_plain in (("main", 48, True), ("at_path_p", path_p, True),
                                  ("at_max_positives_bound", bound_p, False)):
        q_cols = torch.as_tensor(positive_columns(q_pids, g_pids, n_p), device=dev)
        posmask, num_rel, p_dist, p_idx = _positive_prologue(dist, q_cols, ids[1], ids[3], False)
        args = (dist, p_dist, p_idx, ids[0], ids[1], ids[2], ids[3])
        got = positive_rank_counts(*args)
        err = None
        plain_ms = None
        if with_plain:
            check(torch.equal(got, rank_counts_plain(*args)), f"K2 differs from plain at P={n_p}")
            err = 0.0
            plain_ms = cuda_ms(torch, lambda: rank_counts_plain(*args), reps=2, warmup=1)
        ms = cuda_ms(torch, lambda: positive_rank_counts(*args), reps=20)
        valid = int(posmask.sum())
        bytes_ = 4 * n_q * n_g + 8 * n_q * n_p + 8 * (n_q + n_g) + 4 * n_q * n_p
        entry = _timing(f"Q={n_q} G={n_g} P={n_p} valid positives {valid}", ms, plain_ms, None,
                        bytes_, n_g * valid, "f32", err)
        if role == "main":
            results["rank_counts"].update(entry)
        else:
            if not with_plain:
                entry["plain"] = "skipped at this P"
            results["rank_counts"][role] = entry
        log(f"K2 at P={n_p}: {json.dumps(entry)}")
    del dist


def msmt17_ids(seed: int = 6):
    """MSMT17's test protocol ids: 3,060 identities over 82,161 gallery and
    11,659 query rows, 15 cameras → (q_pids, g_pids, q_cams, g_cams)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g_pids = rng.integers(0, 3060, 82161)
    q_pids = rng.integers(0, 3060, 11659)
    return q_pids, g_pids, rng.integers(1, 16, q_pids.size), rng.integers(1, 16, g_pids.size)


def _time_k2_msmt17(torch, dev) -> list:
    """K2 at MSMT17's protocol shape (a 3.83 GB f32 distmat of uniform
    random distances) at P = 64 and 256, ``ignore_camera`` both ways:
    counts equal to the plain version's, kernel and plain times, bound."""
    from daliid_tpu_torch.metrics.ranking import _positive_prologue, positive_columns
    from daliid_tpu_torch.ops.rank_counts import positive_rank_counts, rank_counts_plain

    q_pids, g_pids, q_cams, g_cams = msmt17_ids()
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    dist = torch.rand((q_pids.size, g_pids.size), generator=gen, device=dev)
    n_q, n_g = dist.shape
    ids = [torch.as_tensor(a, dtype=torch.int32, device=dev) for a in (q_pids, q_cams, g_pids, g_cams)]
    out = []
    for n_p in (64, 256):
        q_cols = torch.as_tensor(positive_columns(q_pids, g_pids, n_p), device=dev)
        for ignore in (False, True):
            posmask, _, p_dist, p_idx = _positive_prologue(dist, q_cols, ids[1], ids[3], ignore)
            args = (dist, p_dist, p_idx, ids[0], ids[1], ids[2], ids[3])
            torch.cuda.synchronize()
            t0 = time.time()
            want = rank_counts_plain(*args, ignore_camera=ignore)
            torch.cuda.synchronize()
            plain_ms = (time.time() - t0) * 1e3
            got = positive_rank_counts(*args, ignore_camera=ignore)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"K2 differs from plain at MSMT17's shape P={n_p} ignore_camera={ignore}")
            ms = cuda_ms(torch, lambda: positive_rank_counts(*args, ignore_camera=ignore),
                         reps=10)
            valid = int(posmask.sum())
            bytes_ = 4 * n_q * n_g + 8 * n_q * n_p + 8 * (n_q + n_g) + 4 * n_q * n_p
            entry = _timing(f"Q={n_q} G={n_g} P={n_p} ignore_camera={ignore} valid positives "
                            f"{valid}", ms, plain_ms, None, bytes_, n_g * valid, "f32", 0.0)
            log(f"K2 at MSMT17's protocol shape: {json.dumps(entry)}")
            out.append(entry)
            del want, got
    del dist
    torch.cuda.empty_cache()
    return out


def _time_k1(torch, dev):
    """K1 at the train path's shape in bf16: kernel and plain version."""
    from daliid_tpu_torch.ops.fused_augment import draw_scalars, fused_augment, fused_augment_plain

    b, (h, w), pad = 2 * P * K, IMG, 10
    gen = torch.Generator().manual_seed(9)
    images = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8).to(dev)
    scal = draw_scalars(b, h, w, pad, 0.4, 0.3, 0.4, (0.05, 0.30), (0.3, 3.3), gen).to(dev)
    err = k1_compare(torch, fused_augment(images, scal, pad, torch.bfloat16),
                     fused_augment_plain(images, scal, pad, torch.bfloat16), torch.bfloat16,
                     "the train shape")
    ms = cuda_ms(torch, lambda: fused_augment(images, scal, pad, torch.bfloat16), reps=50)
    plain_ms = cuda_ms(torch, lambda: fused_augment_plain(images, scal, pad, torch.bfloat16),
                       reps=5, warmup=1)
    # each uint8 input byte read once, each bf16 output written once, the table read once
    bytes_ = b * h * w * 3 * (1 + 2) + b * 16 * 4
    # about 30 f32 operations a pixel (crop, jitter, gray, erase, normalize)
    ops = 30 * b * h * w
    return _timing(f"B={b} H={h} W={w} pad={pad} bf16 out", ms, plain_ms, None, bytes_, ops,
                   "f32", err)


def kernel_times(torch, root: str, ps, conv_geos) -> dict:
    """K2 on the Market-like table at each P of ``ps``, K1 at the train
    shape in bf16, ``_QuantConv(conv, absmax)(x)`` on a bf16 batch of 512
    at each geometry of ``conv_geos`` ({name: geometry}) and the int8
    ResNet-50 forward at batch 512, through the tree at ``root`` (imported
    in a process of its own: every tree's package is ``daliid_tpu_torch``;
    both trees have these constructors)."""
    sys.path.insert(0, root)
    from daliid_tpu_torch.metrics.ranking import _positive_prologue, positive_columns
    from daliid_tpu_torch.ops.fused_augment import draw_scalars, fused_augment
    from daliid_tpu_torch.ops.quantize import _QuantConv
    from daliid_tpu_torch.ops.rank_counts import positive_rank_counts

    dev = torch.device("cuda")
    dist, q_pids, g_pids, q_cams, g_cams = market_like(torch, dev)
    ids = [torch.as_tensor(a, dtype=torch.int32, device=dev) for a in (q_pids, q_cams, g_pids, g_cams)]
    out = {}
    for n_p in ps:
        q_cols = torch.as_tensor(positive_columns(q_pids, g_pids, n_p), device=dev)
        _, _, p_dist, p_idx = _positive_prologue(dist, q_cols, ids[1], ids[3], False)
        args = (dist, p_dist, p_idx, ids[0], ids[1], ids[2], ids[3])
        out[f"rank_counts P={n_p}"] = cuda_ms(torch, lambda: positive_rank_counts(*args), reps=50)
    del dist
    b, (h, w), pad = 2 * P * K, IMG, 10
    gen = torch.Generator().manual_seed(9)
    images = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8).to(dev)
    scal = draw_scalars(b, h, w, pad, 0.4, 0.3, 0.4, (0.05, 0.30), (0.3, 3.3), gen).to(dev)
    out["fused_augment bf16"] = cuda_ms(
        torch, lambda: fused_augment(images, scal, pad, torch.bfloat16), reps=100)
    for i, (name, geo) in enumerate(conv_geos.items()):
        torch.manual_seed(70 + i)
        conv = torch.nn.Conv2d(geo["C"], geo["O"], tuple(geo["kernel"]), tuple(geo["stride"]),
                               tuple(geo["padding"]), groups=geo["groups"], bias=False).to(dev)
        x = _conv_inputs(torch, dev, geo, EXTRACT_BATCH, seed=80 + i, dtype=torch.bfloat16)[0]
        layer = _QuantConv(conv, float(x.abs().max()))
        out[f"_QuantConv {name}"] = cuda_ms(torch, lambda: layer(x), reps=10, warmup=2)
        del conv, x, layer
    module, x, plan, q8 = _resnet50_int8(torch, dev)

    def fwd():
        with torch.inference_mode(), q8.quantized(module, plan):
            return module(x)

    out["resnet50 int8 forward at 512"] = cuda_ms(torch, fwd, reps=10, warmup=3)
    return out


def compare(parent_root: str, conv_geos: dict) -> dict:
    """K2, K1, ``_QuantConv`` at ``conv_geos`` and the int8 ResNet-50
    forward of this tree against the tree at ``parent_root`` on one card,
    in turns (parent, this, this, parent), each tree in its own process
    that builds its own kernels → {tree: [times, times]}."""
    from daliid_tpu_torch.metrics.ranking import max_positives_bound, queried_positives_bound

    q_pids, g_pids, _, _ = market_ids()
    ps = (48, queried_positives_bound(q_pids, g_pids), max_positives_bound(g_pids))
    runs = {"parent": [], "this": []}
    for tree, root in (("parent", parent_root), ("this", str(REPO)), ("this", str(REPO)),
                       ("parent", parent_root)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--kernel-times", root,
             ",".join(map(str, ps)), json.dumps(conv_geos)], capture_output=True, text=True,
            timeout=900)
        check(proc.returncode == 0, f"kernel times of {root} failed:\n{proc.stdout[-3000:]}"
                                    f"{proc.stderr[-3000:]}")
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[tree].append(times)
        log(f"compare: {tree} ({root}): {json.dumps(times)}")
    return runs


def _time_k4(torch, dev):
    """K4 at the JPM train shapes in bf16: kernel, plain version, and
    ``scaled_dot_product_attention`` on the same tensors as the yardstick;
    → one timing per shape."""
    import torch.nn.functional as F

    from daliid_tpu_torch.ops.flash_attention import (
        attention_backward,
        attention_plain,
        flash_attention,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    entries = []
    for shape in K4_TRAIN_SHAPES:
        b, n, h, d = shape
        q, k, v = _qkv_views(torch, gen, dev, shape, torch.bfloat16)
        what = f"B={b} N={n} H={h} D={d} bf16, q/k/v strided views of one qkv tensor"
        err = k4_compare(torch, flash_attention(q, k, v), attention_plain(q, k, v),
                         torch.bfloat16, what)
        ms = cuda_ms(torch, lambda: flash_attention(q, k, v), reps=20)
        plain_ms = cuda_ms(torch, lambda: attention_plain(q, k, v), reps=3, warmup=1)
        lib_ms = _library_ms(torch, lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
            "F.scaled_dot_product_attention on the same bf16 views")
        # q, k, v read once and the output written once, 2 bytes each; QK^T and PV
        entries.append(_timing(what, ms, plain_ms, lib_ms, 4 * b * n * h * d * 2,
                               4 * b * h * n * n * d, "bf16", err))
        # the K4 route's gradient, the JAX VJP's backward in plain f32 torch,
        # as autograd calls it on the saved bf16 views
        g_out = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        entries[-1]["backward_ms"] = cuda_ms(torch, lambda: attention_backward(q, k, v, g_out),
                                             reps=5, warmup=1)
        log(f"timing K4 at {shape}: {json.dumps(entries[-1])}")
        del q, k, v, g_out
    return entries


def _time_remat(torch, dev, trainer, images_u8, images, rest, camids) -> dict:
    """21a and 21e: the JPM step with K4 under each remat mode on the same
    weights and batch. First the gradient of one forward and backward from
    one drop-path generator state, under ``none`` twice, ``full`` and
    ``tuned`` (cuDNN's deterministic algorithms, so that the patch
    embedding's weight gradient sums in one order): every gradient and the
    generator's state after it must be bit-equal to ``none``'s, and K4
    launch 16 times a forward plus 16 in ``full``'s recompute. Then each
    mode's step time, img/s and peak memory, and a ``profile_to`` trace of
    one ``tuned`` step around a ``phase`` span, which the trace must name."""
    from daliid_tpu_torch.ops.flash_attention import flash_attention
    from daliid_tpu_torch.utils import phase, profile_to

    model = trainer.online
    set_fused_attention(model, True)
    params = [p for p in model.parameters() if p.requires_grad]
    start = trainer._drop_gen.get_state()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for run in ("none", "none_again", "full", "tuned"):
            mode = run.split("_")[0]
            set_remat(model, mode)
            trainer._drop_gen.set_state(start)
            before = flash_attention.launches
            trainer.forward_backward(images, *rest, camids)
            torch.cuda.synchronize(dev)
            runs[run] = ([p.grad.clone() for p in params], trainer._drop_gen.get_state(),
                         flash_attention.launches - before)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    base_grads, base_state, _ = runs["none"]
    report = {}
    for run, (grads, state, k4) in runs.items():
        recompute = K4_PER_FORWARD["transreid_jpm"] if run == "full" else 0
        check(k4 == K4_PER_FORWARD["transreid_jpm"] + recompute,
              f"remat {run}: K4 launched {k4} times in a forward and backward")
        rel = max(float((g - b).norm() / b.norm().clamp_min(1e-30))
                  for g, b in zip(grads, base_grads))
        equal = all(torch.equal(g, b) for g, b in zip(grads, base_grads))
        check(equal and torch.equal(state, base_state),
              f"remat {run}: the gradient (largest relative L2 {rel:.3g}) or the drop-path "
              f"generator's state differs from none's")
        report[run] = {"k4_launches": k4, "grads_bit_equal_to_none": equal}
    del runs
    for mode in ("none", "full", "tuned"):
        set_remat(model, mode)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        step_ms = cuda_ms(torch, lambda: trainer.train_step(images_u8, *rest, camids),
                          reps=5, warmup=2)
        report[mode].update({"step_ms": step_ms, "img_per_s": images.shape[0] / step_ms * 1e3,
                             "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    trace_dir = WORK / "profile_remat"
    shutil.rmtree(trace_dir, ignore_errors=True)
    with profile_to(str(trace_dir)):
        with phase("remat_tuned_train_step", block_on=images) as elapsed:
            m = trainer.train_step(images_u8, *rest, camids)
    trace = trace_dir / "trace.json"
    check(trace.exists() and "remat_tuned_train_step" in trace.read_text(),
          f"profile_to wrote no trace naming the phase span under {trace_dir}")
    report["profiled_tuned_step"] = {"phase_s": elapsed(), "trace_mb": trace.stat().st_size / 1e6,
                                     "loss": float(m[0])}
    set_remat(model, "none")
    log(f"21a JPM train step with K4 under remat (bf16, {images.shape[0]} images, CUDA events; "
        f"gradients bit-equal to none's): {json.dumps(report)}")
    return report


def _time_jpm(torch, dev, root):
    """One TransReID-JPM train step at 384 images (bf16), split with CUDA
    events into K1, forward+backward and Adam+EMA, with peak device memory,
    once with K4 and once with SDPA on the same weights; the step with K4
    under each remat mode (``_time_remat``); then JPM extraction img/s at
    batch 512 both ways."""
    from daliid_tpu_torch.augment.preprocess import normalize_images
    from daliid_tpu_torch.data import load_dataset
    from daliid_tpu_torch.models import build_model_pair
    from daliid_tpu_torch.train.sampler import PKBatchSampler
    from daliid_tpu_torch.train.trainer import Trainer

    table = load_dataset("Synthetic", root=str(root))["train"]
    online, momentum = build_model_pair(
        "transreid_jpm", torch.Generator().manual_seed(12), img_size=IMG, dtype=torch.bfloat16,
        device=dev, num_classes=table.num_ids, use_fused_attention=True)
    sampler = PKBatchSampler(table, table.pids, P=P, K=K, kind_of_transform=1,
                             turbulence_dir=str(root / "Synthetic" / "turbulence"), seed=12)
    trainer = Trainer(online, momentum, sampler, img_size=IMG, tau=0.05, lambda_proxy=0.4,
                      compute_dtype=torch.bfloat16, extractor_batch=EXTRACT_BATCH)
    pset = trainer.mine_proxies()
    put = lambda a: torch.as_tensor(a, device=dev)
    rest = (put(pset.centers), put(pset.proxies), put(pset.proxy_labels).long(), 1)
    batch = next(iter(sampler.epoch()))
    images_u8, labels, distortions, mask, camids = (t.to(dev) for t in trainer._stage(batch))
    rest = (labels, distortions, mask) + rest
    images = trainer.augment(images_u8)
    out = {"batch": images_u8.shape[0]}
    for route in ("k4", "sdpa"):
        set_fused_attention(trainer.online, route == "k4")
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        step_ms = cuda_ms(torch, lambda: trainer.train_step(images_u8, *rest, camids),
                          reps=5, warmup=2)
        peak = torch.cuda.max_memory_allocated(dev)
        fb_ms = cuda_ms(torch, lambda: trainer.forward_backward(images, *rest, camids), reps=5)
        out[route] = {"step_ms": step_ms, "img_per_s": out["batch"] / step_ms * 1e3,
                      "augment_ms": cuda_ms(torch, lambda: trainer.augment(images_u8), reps=20),
                      "forward_backward_ms": fb_ms,
                      "adam_ema_ms": cuda_ms(torch, trainer.apply_update, reps=5),
                      "peak_memory_gb": peak / 1e9}
    out["remat"] = _time_remat(torch, dev, trainer, images_u8, images, rest, camids)
    model = trainer.extractor.bundle.module
    x = torch.randint(0, 256, (EXTRACT_BATCH, *IMG, 3), dtype=torch.uint8, device=dev)

    def fwd():
        with torch.inference_mode():
            return model(normalize_images(x, dtype=torch.bfloat16)).float()

    for route in ("k4", "sdpa"):
        set_fused_attention(model, route == "k4")
        ms = cuda_ms(torch, fwd, reps=5, warmup=2)
        out[route]["extract_ms_at_512"] = ms
        out[route]["extract_img_per_s_at_512"] = EXTRACT_BATCH / ms * 1e3
    log(f"JPM (bf16, 256x128, {out['batch']} images a step, CUDA events): {json.dumps(out)}")
    del trainer, online, momentum, images, x
    return out


def _profile_steps(torch, step, steps: int) -> dict:
    """``torch.profiler`` over ``steps`` calls of ``step``: the device's busy
    time a step (the union of its kernels' spans), the share of the wall
    time it is busy, and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.time() - t0
    # kernels and copies on the device; user ranges (such as the optimizer's
    # step annotation) span them and would count their gaps as busy
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    check(len(spans) > 0, "the profiler saw no kernel on the device")
    busy, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    bn = sum(t for name, t in by_name.items() if "batch_norm" in name)
    return {"profiled_device_busy_ms_per_step": busy / 1e3 / steps,
            "profiled_busy_share": busy / 1e6 / wall,
            "kernels_per_step": len(spans) / steps,
            "batch_norm_kernels_ms_per_step": bn / 1e3 / steps,
            "top_kernels_ms_per_step": {name[:80]: t / 1e3 / steps for name, t in top}}


def _time_train_step(torch, dev, root):
    """One train step at the path's shape, split with CUDA events into K1
    augment, forward+backward and Adam+EMA; the whole step's img/s and peak
    device memory; the host decode time of one batch and the prefetching
    loop's steady rate with the native loader and with PIL (the native
    loader's batch held against PIL's, mean |diff| < 1.5, p99 <= 6)."""
    import numpy as np

    from daliid_tpu_torch.data import load_dataset, native_loader
    from daliid_tpu_torch.models import build_model_pair
    from daliid_tpu_torch.train.sampler import PKBatchSampler
    from daliid_tpu_torch.train.trainer import Trainer

    table = load_dataset("Synthetic", root=str(root))["train"]
    online, momentum = build_model_pair("resnet50", torch.Generator().manual_seed(12),
                                        dtype=torch.bfloat16, device=dev)
    sampler = PKBatchSampler(table, table.pids, P=P, K=K, kind_of_transform=1,
                             turbulence_dir=str(root / "Synthetic" / "turbulence"), seed=12)
    trainer = Trainer(online, momentum, sampler, img_size=IMG, tau=0.05, lambda_proxy=0.4,
                      compute_dtype=torch.bfloat16, extractor_batch=512)
    pset = trainer.mine_proxies()
    put = lambda a: torch.as_tensor(a, device=dev)
    centers, proxies, proxy_labels = put(pset.centers), put(pset.proxies), \
        put(pset.proxy_labels).long()
    batch = next(iter(sampler.epoch()))
    rest = (centers, proxies, proxy_labels, 1)
    batches = [b for _ in range(PIPELINE_BATCHES // 2) for b in sampler.epoch()]
    default_workers = trainer.decode_workers
    decoders = {"pil": False}
    if native_loader.native_loader_available():
        decoders = {"native": True, "pil": False}
        native = trainer._decode_batch(batch.paths)
    host = {}
    available = native_loader.native_loader_available
    try:
        for decoder, on in decoders.items():
            # PIL takes over the same decode calls while the loader is switched off
            native_loader.native_loader_available = available if on else (lambda: False)
            decoded = trainer._decode_batch(batch.paths)  # warm the decode path
            if decoder == "pil" and "native" in decoders:
                diff = np.abs(native.astype(np.int32) - decoded.astype(np.int32))
                check(diff.mean() < 1.5 and np.percentile(diff, 99) <= 6,
                      f"the native loader differs from PIL: mean |diff| {diff.mean():.3f}")
                host["native_vs_pil_mean_abs_diff"] = float(diff.mean())
            decode_ms = {}
            for workers in sorted({1, 4, default_workers}):
                trainer.decode_workers = workers
                t0 = time.time()
                for _ in range(2):
                    trainer._decode_batch(batch.paths)
                decode_ms[workers] = (time.time() - t0) / 2 * 1e3
            trainer.decode_workers = default_workers
            # the train loop as it runs: decode on the prefetch thread, steps on
            # the card; timed from the second batch's arrival, after the fill
            arrivals = []
            for images_u8, labels, distortions, mask, _ in trainer.staged_batches(batches):
                arrivals.append(time.time())
                trainer.train_step(images_u8, labels, distortions, mask, *rest)
            torch.cuda.synchronize(dev)
            pipeline_ms = (time.time() - arrivals[1]) / (len(batches) - 1) * 1e3
            host[decoder] = {"host_decode_ms_per_batch": decode_ms[default_workers],
                             "host_decode_ms_by_threads": decode_ms,
                             "pipeline_ms_per_step": pipeline_ms,
                             "pipeline_img_per_s": len(batch.paths) / pipeline_ms * 1e3}
    finally:
        native_loader.native_loader_available = available
    path = host["native" if "native" in decoders else "pil"]
    images_u8, labels, distortions, mask, _ = (t.to(dev) for t in trainer._stage(batch))
    rest = (labels, distortions, mask) + rest
    images = trainer.augment(images_u8)
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(torch, lambda: trainer.train_step(images_u8, *rest), reps=10, warmup=3)
    peak = torch.cuda.max_memory_allocated(dev)
    aug_ms = cuda_ms(torch, lambda: trainer.augment(images_u8), reps=20)
    fb_ms = cuda_ms(torch, lambda: trainer.forward_backward(images, *rest), reps=10)
    upd_ms = cuda_ms(torch, trainer.apply_update, reps=10)
    b = images_u8.shape[0]
    split = {"batch": b, "step_ms": step_ms, "img_per_s": b / step_ms * 1e3,
             "augment_ms": aug_ms, "forward_backward_ms": fb_ms, "adam_ema_ms": upd_ms,
             "peak_memory_gb": peak / 1e9, **path, "host_by_decoder": host,
             "host_cpus": os.cpu_count(), "pipeline_steps": len(batches) - 1,
             **_profile_steps(torch, lambda: trainer.train_step(images_u8, *rest), steps=3)}
    log(f"train step (ResNet-50 bf16, {b} images of 256x128, CUDA events): {json.dumps(split)}")
    del trainer, online, momentum, images
    return split


def _time_extraction(torch, dev):
    from daliid_tpu_torch.augment.preprocess import normalize_images
    from daliid_tpu_torch.models import get_model

    bundle = get_model("resnet50", torch.Generator().manual_seed(12), dtype=torch.bfloat16,
                       device=dev)
    rates = {}
    for batch in (64, 512):
        x = torch.randint(0, 256, (batch, 256, 128, 3), dtype=torch.uint8, device=dev)

        def fwd():
            with torch.inference_mode():
                return bundle.module(normalize_images(x, dtype=torch.bfloat16)).float()

        ms = cuda_ms(torch, fwd, reps=10, warmup=3)
        rates[batch] = batch / ms * 1e3
        log(f"ResNet-50 bf16 256x128 forward (normalize included) at batch {batch}: "
            f"{ms:.3f} ms, {rates[batch]:.1f} img/s")
    return rates


def _time_zoo_extraction(torch, dev) -> dict:
    """Each zoo family's bf16 forward at batch 512 (normalize included):
    ms, img/s and peak device memory."""
    from daliid_tpu_torch.augment.preprocess import normalize_images
    from daliid_tpu_torch.models import get_model

    x = torch.randint(0, 256, (EXTRACT_BATCH, *IMG, 3), dtype=torch.uint8, device=dev)
    out = {}
    for name in ZOO:
        bundle = get_model(name, torch.Generator().manual_seed(12), dtype=torch.bfloat16,
                           device=dev)

        def fwd():
            with torch.inference_mode():
                return bundle.module(normalize_images(x, dtype=torch.bfloat16)).float()

        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(torch, fwd, reps=10, warmup=3)
        out[name] = {"ms": ms, "img_per_s": EXTRACT_BATCH / ms * 1e3,
                     "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        log(f"{name} bf16 256x128 forward at batch {EXTRACT_BATCH}: {json.dumps(out[name])}")
        del bundle
    return out


def _time_densenet_train_step(torch, dev, root) -> dict:
    """One ``densenet121`` train step (classifier head of one class per
    training identity, bf16, 384 images) with CUDA events: ms, img/s, peak
    device memory."""
    from daliid_tpu_torch.data import load_dataset
    from daliid_tpu_torch.models import build_model_pair
    from daliid_tpu_torch.train.sampler import PKBatchSampler
    from daliid_tpu_torch.train.trainer import Trainer

    table = load_dataset("Synthetic", root=str(root))["train"]
    online, momentum = build_model_pair("densenet121", torch.Generator().manual_seed(12),
                                        dtype=torch.bfloat16, device=dev,
                                        num_classes=table.num_ids)
    sampler = PKBatchSampler(table, table.pids, P=P, K=K, kind_of_transform=1,
                             turbulence_dir=str(root / "Synthetic" / "turbulence"), seed=12)
    trainer = Trainer(online, momentum, sampler, img_size=IMG, tau=0.05, lambda_proxy=0.4,
                      compute_dtype=torch.bfloat16, extractor_batch=EXTRACT_BATCH)
    pset = trainer.mine_proxies()
    put = lambda a: torch.as_tensor(a, device=dev)
    rest = (put(pset.centers), put(pset.proxies), put(pset.proxy_labels).long(), 1)
    images_u8, labels, distortions, mask, _ = (t.to(dev) for t in trainer._stage(
        next(iter(sampler.epoch()))))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(torch, lambda: trainer.train_step(images_u8, labels, distortions, mask, *rest),
                 reps=5, warmup=2)
    b = images_u8.shape[0]
    out = {"batch": b, "step_ms": ms, "img_per_s": b / ms * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    log(f"densenet121 train step (bf16, {b} images of 256x128, CUDA events): {json.dumps(out)}")
    del trainer, online, momentum
    return out


def _time_rerank(torch, dev) -> dict:
    """``re_ranking`` at Market-1501's protocol shape (Q=3,368, G=15,913:
    N = 19,281) on cosine distances of random unit 2048-d embeddings: ms
    and the peak device memory above its three input matrices; and the
    re-ranked search of 200 probes over a 400-row SQ8 index at depth 64
    (host clock, the call returns numpy), with its device re-ranking alone
    (CUDA events)."""
    import numpy as np

    from daliid_tpu_torch.eval.matcher import GalleryIndex
    from daliid_tpu_torch.eval.rerank import re_ranking, rerank_shortlists
    from daliid_tpu_torch.metrics.ranking import cosine_distance_matrix

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    unit = lambda n: torch.nn.functional.normalize(
        torch.randn(n, 2048, device=dev, generator=gen), dim=1)
    q, g = unit(3368), unit(15913)
    mats = [cosine_distance_matrix(a, b) for a, b in ((q, g), (q, q), (g, g))]
    del q, g
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    first = re_ranking(*mats)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    check(bool(torch.isfinite(first).all()) and first.shape == (3368, 15913),
          "re_ranking at Market's shape is not finite")
    del first
    ms = cuda_ms(torch, lambda: re_ranking(*mats), reps=3, warmup=1)
    del mats
    out = {"market_ms": ms, "market_peak_memory_gb": peak / 1e9}

    rng = np.random.default_rng(7)
    rows = rng.normal(size=(400, 2048)).astype(np.float32)
    probes = rows[rng.integers(0, 400, 200)] + 0.3 * rng.normal(size=(200, 2048)).astype(
        np.float32)
    index = GalleryIndex(rows, np.arange(400), quantize="int8", device=dev)
    search = lambda: index.search(probes, k=10, rerank=True, rerank_depth=64)
    search()
    t0 = time.time()
    for _ in range(5):
        search()
    out["search_q200_g400_depth64_ms"] = (time.time() - t0) / 5 * 1e3
    fulls = torch.rand(200, 65, 65, device=dev, generator=gen)
    fulls = (fulls + fulls.transpose(1, 2)) / 2
    out["shortlists_q200_depth64_device_ms"] = cuda_ms(
        torch, lambda: rerank_shortlists(fulls, 20, 6, 0.3), reps=10)
    log(f"re-ranking timings: {json.dumps(out)}")
    return out


def _time_conv_int8(torch, dev, shapes) -> dict:
    """conv_int8 on the layer's bf16 input (bf16 out, no bias: the path's
    convolutions feed a BN) at each of ``CONV_LAYERS``' shapes at batch 512,
    weights packed once as the path packs them, against its bound (the bf16
    input, the int8 weights, the scales and the output once each, or the
    int8 operations), its plain version (``quantize_sym`` and the exact
    sum), the route of PyTorch calls ``quantize_sym`` + im2col +
    ``torch._int_mm`` (groups = 1; its int32 held equal to the kernel's),
    cuDNN's bf16 convolution of the same shape (context), and the kernel on
    the input already quantized to int8; → {(model, layer): timing}."""
    import torch.nn.functional as F

    from daliid_tpu_torch.ops.conv_int8 import (
        conv_int8,
        conv_int8_plain,
        kernel_plan,
        pack_weights,
        quantize_sym,
    )

    s_in = 0.0123
    s_t = torch.full((), s_in, dtype=torch.float32, device=dev)
    out = {}
    for i, (key, geo) in enumerate(shapes.items()):
        x, wq, s_w, _ = _conv_inputs(torch, dev, geo, EXTRACT_BATCH, seed=60 + i,
                                     dtype=torch.bfloat16)
        kh, kw = geo["kernel"]
        args = (geo["stride"], geo["padding"], geo["groups"])
        k = kh * kw * geo["C"] // geo["groups"]
        wp = pack_weights(wq, geo["groups"])
        ms = cuda_ms(torch, lambda: conv_int8(x, wq, *args, s_in, s_w, None, torch.bfloat16,
                                              w_packed=wp), reps=20, warmup=3)
        plain_ms = cuda_ms(torch, lambda: conv_int8_plain(x, wq, *args, s_in, s_w, None,
                                                          torch.bfloat16), reps=2, warmup=1)
        xq = quantize_sym(x, s_t).contiguous(memory_format=torch.channels_last)
        int8_in_ms = cuda_ms(torch, lambda: conv_int8(xq, wq, *args, s_in, s_w, None,
                                                      torch.bfloat16, w_packed=wp), reps=20)
        y = conv_int8(x, wq, *args, s_in, s_w, None, torch.int32, w_packed=wp)
        n_b, o, ho, wo = y.shape
        lib_ms, lib_equal = None, None
        if geo["groups"] == 1:
            k_pad = -(-k // 8) * 8
            wmat = F.pad(wq.permute(0, 3, 1, 2).reshape(o, k), (0, k_pad - k)).t()

            def im2col_int_mm():
                cols = F.unfold(quantize_sym(x, s_t).to(torch.bfloat16), (kh, kw),
                                padding=geo["padding"], stride=geo["stride"])
                a = cols.transpose(1, 2).reshape(-1, k).to(torch.int8)
                return torch._int_mm(F.pad(a, (0, k_pad - k)), wmat)

            lib_equal = bool(torch.equal(im2col_int_mm().view(n_b, ho * wo, o),
                                         y.permute(0, 2, 3, 1).reshape(n_b, ho * wo, o)))
            check(lib_equal, f"im2col + _int_mm differs from conv_int8 at {_geo_str(key, geo)}")
            lib_ms = _library_ms(torch, im2col_int_mm,
                                 "quantize_sym + F.unfold(bf16) + torch._int_mm")
        w_bf = wq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        cudnn_ms = cuda_ms(torch, lambda: F.conv2d(x, w_bf, None, geo["stride"],
                                                   geo["padding"], 1, geo["groups"]), reps=20)
        m = n_b * ho * wo
        bytes_ = x.numel() * x.element_size() + wq.numel() + 4 * o + 2 * m * o
        t = _timing(_geo_str(key, geo), ms, plain_ms, None, bytes_, 2 * m * o * k, "int8", 0.0)
        t.update({"plan": kernel_plan(x.shape, wq.shape, *args),
                  "im2col_int_mm_ms": lib_ms, "cudnn_bf16_ms": cudnn_ms,
                  "int8_input_ms": int8_in_ms})
        out[key] = t
        log(f"timing conv_int8 {t['shape']} ({t['plan']}): kernel {ms:.4f} ms on bf16 "
            f"(on int8 {int8_in_ms:.4f}), bound {t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
            f"{plain_ms:.3f} ms, quantize_sym + im2col + _int_mm {lib_ms} ms (int32 equal: "
            f"{lib_equal}), cuDNN bf16 {cudnn_ms:.4f} ms")
        del x, xq, wq, w_bf, y
    return out


def _resnet50_int8(torch, dev, root_module=None):
    """ResNet-50 (bf16, 256x128, seed 12) with its int8 plan calibrated on a
    batch of 512 random images → (module, normalized batch, plan, the
    quantize module used)."""
    from daliid_tpu_torch.augment.preprocess import normalize_images
    from daliid_tpu_torch.models import get_model
    from daliid_tpu_torch.ops import quantize as q8

    gen = torch.Generator().manual_seed(13)
    images = torch.randint(0, 256, (EXTRACT_BATCH, *IMG, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    module = get_model("resnet50", torch.Generator().manual_seed(12), img_size=IMG,
                       dtype=torch.bfloat16, device=dev).module
    x = normalize_images(images, dtype=torch.bfloat16)
    plan = q8.prepare(module, q8.calibrate(module, x))
    return module, x, plan, q8


def _profile_int8_resnet(torch, dev) -> dict:
    """One ``torch.profiler`` pass over the int8 ResNet-50 forward at batch
    512 (the normalized batch made before it): the device time of
    conv_int8's kernels against everything else, that no quantize pass
    (``aten::round`` / ``aten::clamp``) runs, and that conv_int8 launched
    once for each of the 53 convolutions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from daliid_tpu_torch.ops.conv_int8 import conv_int8

    module, x, plan, q8 = _resnet50_int8(torch, dev)

    def fwd():
        with torch.inference_mode(), q8.quantized(module, plan):
            return module(x)

    fwd()
    torch.cuda.synchronize(dev)
    before = conv_int8.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd()
        torch.cuda.synchronize(dev)
    launched = conv_int8.launches - before
    ops = {e.key for e in prof.key_averages()}
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    check(len(kernels) > 0, "the profiler saw no kernel on the device")
    conv_us = sum(e.time_range.elapsed_us() for e in kernels
                  if "conv_wgmma" in e.name or "conv_dw" in e.name)
    total_us = sum(e.time_range.elapsed_us() for e in kernels)
    quantize_ops = sorted(op for op in ops if op in ("aten::round", "aten::clamp"))
    check(launched == 53, f"the int8 ResNet-50 forward launched conv_int8 {launched} times, "
                          f"not once for each of its 53 convolutions")
    check(not quantize_ops, f"the int8 ResNet-50 forward ran quantize passes {quantize_ops}")
    top = {}
    for e in kernels:
        top[e.name[:80]] = top.get(e.name[:80], 0.0) + e.time_range.elapsed_us() / 1e3
    out = {"conv_int8_launches": launched, "conv_int8_device_ms": conv_us / 1e3,
           "other_device_ms": (total_us - conv_us) / 1e3, "kernels": len(kernels),
           "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])[:8])}
    log(f"profiled int8 ResNet-50 forward at batch {EXTRACT_BATCH}: {json.dumps(out)}; no "
        f"aten::round / aten::clamp")
    del module, x, plan
    return out


def _time_int8_extraction(torch, dev) -> dict:
    """Each model's int8 forward at batch 512 (normalize included, scales
    calibrated on the batch) against its bf16 forward in the same call:
    ms, img/s, the int8 run's peak device memory. ViT-B with K4."""
    from daliid_tpu_torch.augment.preprocess import normalize_images
    from daliid_tpu_torch.models import get_model
    from daliid_tpu_torch.ops import quantize as q8

    x = torch.randint(0, 256, (EXTRACT_BATCH, *IMG, 3), dtype=torch.uint8, device=dev)
    out = {}
    for name in ("resnet50", *ZOO, "vit"):
        kw = {"use_fused_attention": True} if name == "vit" else {}
        module = get_model(name, torch.Generator().manual_seed(12), img_size=IMG,
                           dtype=torch.bfloat16, device=dev, **kw).module
        plan = q8.prepare(module, q8.calibrate(module, normalize_images(x, dtype=torch.bfloat16)))

        def fwd(plan):
            with torch.inference_mode(), q8.quantized(module, plan):
                return module(normalize_images(x, dtype=torch.bfloat16)).float()

        bf16_ms = cuda_ms(torch, lambda: fwd({}), reps=10, warmup=3)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        int8_ms = cuda_ms(torch, lambda: fwd(plan), reps=10, warmup=3)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        out[name] = {"int8_ms": int8_ms, "int8_img_per_s": EXTRACT_BATCH / int8_ms * 1e3,
                     "bf16_ms": bf16_ms, "bf16_img_per_s": EXTRACT_BATCH / bf16_ms * 1e3,
                     "int8_peak_memory_gb": peak, "int8_layers": len(plan)}
        log(f"{name} int8 256x128 forward at batch {EXTRACT_BATCH}: {json.dumps(out[name])}")
        del module, plan
    return out


# ---------------------------------------------------------------- phase 20: multi-process
# the crash drill's runs: 3 epochs of 2 steps over the 32-identity train set
DRILL_EPOCHS = 3
# the gang's train step, timed over this many steps after 2 of warm-up
GANG_STEPS = 5
# the bounded-memory ranking's query chunk (MSMT17's 11,659 queries: 23 chunks)
RANK_CHUNK = 512
# how far two runs whose gradients differ in their last bits may part in a
# step: Adam moves a parameter by at most about 3.2 lr ((1 - b1) / sqrt(1 - b2)
# at 0.9, 0.999) whatever its gradient's size, each run so, at lr 3.5e-4
ADAM_PART = 2 * 3.2 * 3.5e-4
# the gang's first step (f32) against one process's: the summed gradient in
# relative L2 norm, and each BN running-statistics update (after - before)
# within this share of its largest entry. ResNet-50's step at its
# initialization is chaotic: one process against itself with torch's
# native BN kernels in place of cuDNN's (the same function, rounded
# differently) moves the gradient by about 2e-2 (printed as the floor), so
# the tolerance is twice that; a gang that sums one rank's gradient, skips
# the all-reduce or the BN reduction is off by 0.5 or more
GRAD_L2_TOL = 4e-2
BN_STEP_TOL = 1e-4
# after the 2-step bf16 epoch, where bf16 rounding alone decorrelates the
# chaotic gradients (Adam's moments 1.0-1.3 apart in relative L2 norm) and
# so the second step's activations: the BN running statistics within this
# relative L2 distance of one process's (measured 0.043); Adam's moments'
# norms within this factor of one process's either way (a sum over the
# ranks gone wrong scales them)
BN_EPOCH_TOL = 0.1
MOMENT_NORM_FACTOR = 1.5


def _train_flags(root, ckpt, epochs: int, eval_freq: int = 100) -> list:
    """The train CLI at its defaults (ResNet-50, P16 K12 paired), bf16, a
    crash-resume checkpoint every epoch, no initial validation."""
    return ["--dataset", "Synthetic", "--data_root", str(root), "--model_name", "resnet50",
            "--compute_dtype", COMPUTE_DTYPE, "--P", str(P), "--K", str(K),
            "--epochs", str(epochs), "--eval_freq", str(eval_freq), "--skip_initial_eval",
            "--ckpt_freq", "1", "--path_to_save_models", str(ckpt),
            "--path_to_save_metrics", f"{ckpt}_metrics", *_img_flags()]


def _run_children(cmds, name: str, timeout: float, on_line=None) -> list:
    """Run ``cmds`` at once, each in its own process group, their output in
    ``build/chip_smoke/<name>_<i>.log``; kill every group at ``timeout`` →
    the outputs. Any command that fails fails the phase."""
    procs, logs = [], []
    for i, cmd in enumerate(cmds):
        logs.append(open(WORK / f"{name}_{i}.log", "w"))
        procs.append(subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      start_new_session=True))
    outs = [[] for _ in cmds]

    def pump(i):
        for line in procs[i].stdout:
            outs[i].append(line)
            logs[i].write(line)
            if on_line is not None:
                on_line(line)

    pumps = [threading.Thread(target=pump, args=(i,), daemon=True) for i in range(len(cmds))]
    for t in pumps:
        t.start()
    deadline = time.time() + timeout
    for t in pumps:
        t.join(max(0.0, deadline - time.time()))
    hung = False
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            hung = True
    for p in procs:  # whatever is left of the process groups
        try:
            os.killpg(p.pid, 9)
        except ProcessLookupError:
            pass
        p.wait()
    for f in logs:
        f.close()
    texts = ["".join(o) for o in outs]
    for i, (p, text) in enumerate(zip(procs, texts)):
        check(not hung and p.returncode == 0,
              f"{name} process {i} exited {p.returncode}"
              f"{f' (killed past {timeout:.0f} s)' if hung else ''}:\n{text[-3000:]}")
    return texts


def _supervise(name: str, multihost: int, root, epochs: int, *extra) -> list:
    """The command of ``python -m daliid_tpu_torch supervise --multihost N``
    over the train CLI, checkpoints under ``build/chip_smoke/<name>``."""
    ckpt = WORK / name
    shutil.rmtree(ckpt, ignore_errors=True)
    return [sys.executable, "-m", "daliid_tpu_torch", "supervise", "--multihost", str(multihost),
            "--max_restarts", "1", "--backoff_seconds", "0", "--teardown_grace_seconds", "5",
            "--", *_train_flags(root, ckpt, epochs), *extra]


def _leaves(tree, path=""):
    """(path, tensor) of every tensor in a nested checkpoint state."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif hasattr(tree, "dtype"):
        yield path, tree


def _state_diff(torch, a, b) -> dict:
    """Two checkpoint states compared leaf by leaf → per group (parameters,
    BN statistics, Adam's first and second moments and step counts) the
    count of bit-equal leaves, the largest |difference|, the largest
    |difference| of a leaf over that leaf's largest |entry| in ``b``, and
    the group's relative L2 distance ``|a - b| / |b|`` and norm ratio
    ``|a| / |b|``."""
    lb, out = dict(_leaves(b)), {}
    for path, x in _leaves(a):
        y = lb[path]
        group = (("adam_m" if path.endswith("exp_avg") else "adam_v"
                  if path.endswith("exp_avg_sq") else "adam") if path.startswith("/optimizer")
                 else "bn_stats" if "running_" in path else "params")
        g = out.setdefault(group, {"leaves": 0, "bit_equal": 0, "max_abs_diff": 0.0,
                                   "max_rel_to_largest": 0.0, "sq_diff": 0.0, "sq_a": 0.0,
                                   "sq_ref": 0.0})
        g["leaves"] += 1
        g["bit_equal"] += int(torch.equal(x, y))
        if x.is_floating_point() and x.numel():
            d, ref = (x.double() - y.double()).abs(), y.double().abs()
            g["max_abs_diff"] = max(g["max_abs_diff"], float(d.max()))
            g["max_rel_to_largest"] = max(g["max_rel_to_largest"],
                                          float(d.max() / ref.max().clamp_min(1e-30)))
            g["sq_diff"] += float((d * d).sum())
            g["sq_a"] += float((x.double() ** 2).sum())
            g["sq_ref"] += float((ref * ref).sum())
    for g in out.values():
        ref = max(g.pop("sq_ref"), 1e-300)
        g["rel_l2"] = (g.pop("sq_diff") / ref) ** 0.5
        g["norm_ratio"] = (g.pop("sq_a") / ref) ** 0.5
    return out


def _drill_trainer(torch, dev, root, dtype_name: str = COMPUTE_DTYPE):
    """A Trainer as the train CLI builds it for the drill's runs."""
    from daliid_tpu_torch.data import load_dataset
    from daliid_tpu_torch.device import parse_dtype
    from daliid_tpu_torch.models import build_model_pair
    from daliid_tpu_torch.train.sampler import PKBatchSampler
    from daliid_tpu_torch.train.trainer import Trainer

    dtype = parse_dtype(dtype_name)
    table = load_dataset("Synthetic", root=str(root))["train"]
    online, momentum = build_model_pair("resnet50", torch.Generator().manual_seed(12),
                                        img_size=IMG, dtype=dtype, device=dev)
    sampler = PKBatchSampler(table, table.pids, P=P, K=K, kind_of_transform=1,
                             turbulence_dir=str(root / "Synthetic" / "turbulence"), seed=12)
    return Trainer(online, momentum, sampler, img_size=IMG, tau=0.05, lambda_proxy=0.4,
                   compute_dtype=dtype, extractor_batch=512)


def phase_drill(torch, dev, root) -> dict:
    """20a: the crash drill on one rank, on NCCL, and on one plain process."""
    import numpy as np

    from daliid_tpu_torch.train.checkpoint import CheckpointManager

    t0 = time.time()
    # the clean gang run and the single-process drill at once (they share
    # nothing but the card)
    clean, single = _run_children(
        [_supervise("drill_clean", 1, root, DRILL_EPOCHS),
         _supervise("drill_single", 0, root, 2, "--fault_inject_epoch", "2")], "drill", 600)
    check("training completed after 1 attempt(s)" in clean, "the clean drill run did not finish")
    check(_multihost_info(clean)["backend"] == "nccl",
          "the 1-rank gang did not run on NCCL")
    for line in ("fault injection: simulated crash after epoch 2", "trainer exited rc=1",
                 "[supervise] attempt 2", "Resumed from epoch 1",
                 "training completed after 2 attempt(s)"):
        check(line in single, f"the single-process drill printed no {line!r}")
    check("multihost:" not in single, "supervise --multihost 0 started a gang")
    t1 = time.time()
    snap = WORK / "drill_restore" / "1.pt"
    shutil.rmtree(snap.parent, ignore_errors=True)

    def on_line(line):  # the epoch-1 checkpoint, when the trainer dies
        if "exited rc=" in line and not snap.exists():
            snap.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(WORK / "drill_fault" / "latest" / "1.pt", snap)

    fault = _run_children([_supervise("drill_fault", 1, root, DRILL_EPOCHS,
                                      "--fault_inject_epoch", "2", "--fault_inject_rank", "0")],
                          "drill_fault", 600, on_line)[0]
    for line in ("fault injection: SIGKILL rank 0 after epoch 2", "exited rc=-9",
                 "[supervise] attempt 2", "Resumed from epoch 1",
                 "training completed after 2 attempt(s)"):
        check(line in fault, f"the NCCL drill printed no {line!r}")
    check(all(i["backend"] == "nccl" for i in _multihost_infos(fault)),
          "the drill's gang did not run on NCCL")
    t2 = time.time()
    # what the resumed run restored: the epoch-1 checkpoint through the
    # Trainer and back, bit for bit
    check(snap.exists(), "no epoch-1 checkpoint when the trainer died")
    state, epoch, rng = CheckpointManager(str(snap.parent), track_best=False).restore(epoch=1)
    check(epoch == 1, f"the snapshot holds epoch {epoch}")
    trainer = _drill_trainer(torch, dev, root)
    trainer.load_state_dict(state)
    trainer.set_rng_state(rng)
    back = trainer.state_dict()
    restore = _state_diff(torch, state, _to_cpu(torch, back))
    check(all(g["bit_equal"] == g["leaves"] for g in restore.values()),
          f"the restored state differs from the epoch-1 checkpoint: {restore}")
    check(all(np.array_equal(trainer.rng_state()[k], v) for k, v in rng.items()),
          "the restored RNG streams differ from the checkpoint's")
    del trainer
    torch.cuda.empty_cache()
    a = torch.load(WORK / "drill_clean" / "latest" / f"{DRILL_EPOCHS}.pt", weights_only=True)
    b = torch.load(WORK / "drill_fault" / "latest" / f"{DRILL_EPOCHS}.pt", weights_only=True)
    stitched = _state_diff(torch, a["state"], b["state"])
    rng_equal = all(torch.equal(a["rng"][k], b["rng"][k]) for k in a["rng"])
    exact = all(g["bit_equal"] == g["leaves"] for g in stitched.values())
    check(rng_equal, "the stitched run's RNG streams differ from the clean run's")
    check(exact, f"the stitched state is not the clean one bit for bit: {stitched}")
    info = {"clean_and_single_s": t1 - t0, "fault_s": t2 - t1, "stitched_bit_exact": exact,
            "stitched_vs_clean": stitched, "restored_bit_exact": True}
    log(f"20a crash drill (ResNet-50 {COMPUTE_DTYPE}, P{P} K{K} paired, {DRILL_EPOCHS} epochs "
        f"of {TRAIN_IDS // P} steps): supervise --multihost 1 on NCCL clean, beside supervise "
        f"--multihost 0 (the process raises after epoch 2, resumes from 1) "
        f"{info['clean_and_single_s']:.1f} s; SIGKILL of rank 0 after epoch 2 and resume from "
        f"epoch 1 {info['fault_s']:.1f} s (restored state equal to the epoch-1 checkpoint bit "
        f"for bit); stitched against clean: bit-exact {json.dumps(stitched)}")
    return info


def _to_cpu(torch, tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(torch, v) for v in tree)
    return tree.cpu() if hasattr(tree, "cpu") else tree


class _RecordExtract:
    """Records what every ``FeatureExtractor.extract`` returns while active."""

    def __init__(self):
        from daliid_tpu_torch.eval import features

        self.cls, self.original, self.out = features.FeatureExtractor, \
            features.FeatureExtractor.extract, []

    def __enter__(self):
        original, out = self.original, self.out

        def extract(ex, *a, **kw):
            res = original(ex, *a, **kw)
            out.append(res)
            return res

        self.cls.extract = extract
        return self

    def __exit__(self, *exc):
        self.cls.extract = self.original


def _cli_arrays(module: str, res) -> dict:
    """A CLI's result as arrays: evaluate's CMC and mAP, search's answer."""
    import numpy as np

    if module == "evaluate":
        cmc, mAP = res["Synthetic"]
        return {"cmc": np.asarray(cmc), "map": np.asarray([mAP])}
    if module == "search":
        return dict(zip(("sims", "ids", "pids"), (np.asarray(r) for r in res)))
    return {}


class _NativeBatchNorm:
    """While active, one process's BN runs torch's native CUDA kernels
    instead of cuDNN's: the same function, rounded differently."""

    def __enter__(self):
        import torch

        from daliid_tpu_torch.models.norm import TorchBatchNorm

        self.cls, self.original = TorchBatchNorm, TorchBatchNorm.forward
        original = self.original

        def forward(bn, x):
            with torch.backends.cudnn.flags(enabled=False):
                return original(bn, x)

        TorchBatchNorm.forward = forward
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.original

def _first_step(torch, root, dtype_name: str) -> dict:
    """The drill's Trainer's first step up to Adam in ``dtype_name`` (this
    rank's block of the batch in a gang) → its flat gradient, summed over
    the gang, and each BN running statistic's update (after - before), as
    arrays."""
    import numpy as np

    dev = torch.device("cuda")
    trainer = _drill_trainer(torch, dev, root, dtype_name)

    def stats():
        return {k.replace(".", "/"): v.detach().clone() for k, v in
                trainer.online.state_dict().items() if "running_" in k}

    pset = trainer.mine_proxies()
    before = stats()
    images_u8, labels, dist, mask, camids = (t.to(dev) for t in trainer._stage(
        next(iter(trainer.sampler.epoch()))))
    trainer.forward_backward(trainer.augment(images_u8), labels, dist, mask,
                             torch.as_tensor(pset.centers, device=dev),
                             torch.as_tensor(pset.proxies, device=dev),
                             torch.as_tensor(pset.proxy_labels, device=dev).long(), 1, camids)
    grad = torch.cat([p.grad.reshape(-1).float() for p in trainer._params if p.grad is not None])
    out = {"grad": grad.cpu().numpy()}
    out.update({f"bn{k}": (v - before[k]).cpu().numpy() for k, v in stats().items()})
    del trainer
    torch.cuda.empty_cache()
    return {k: np.asarray(v) for k, v in out.items()}


def _gang_bn_check(torch) -> dict:
    """In a 1-rank gang: the gang BN's fused path (``_GangBatchNorm``)
    against its eager version (``_global_batch_norm_plain``) and against
    one process's BN (cuDNN's ``F.batch_norm``) on the same bf16 input at
    ResNet-50's layer1 shape (384 x 256 x 64 x 32, channels-last,
    per-channel scales and shifts): the output, the input's and the
    affine's gradients and the running statistics, each's largest
    |difference| over its largest |entry|; the forward + backward time of
    all three."""
    import copy

    from daliid_tpu_torch.models.norm import TorchBatchNorm
    from daliid_tpu_torch.parallel import mesh

    check(mesh.active(), "the BN check runs in a gang")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    c = 256
    scale = torch.rand((1, c, 1, 1), generator=gen, device=dev) * 3 + 0.1
    shift = torch.randn((1, c, 1, 1), generator=gen, device=dev)
    x = (torch.randn((2 * P * K, c, 64, 32), generator=gen, device=dev) * scale + shift)
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    base = TorchBatchNorm(c, dtype=torch.bfloat16).to(dev).train()
    with torch.no_grad():
        base.weight.uniform_(0.5, 1.5, generator=gen)
        base.bias.uniform_(-0.2, 0.2, generator=gen)

    def run(bn, forward):
        xi = x.detach().clone().requires_grad_(True)
        y = forward(bn, xi)
        y.backward(dy)
        return {"y": y.float(), "grad_x": xi.grad.float(), "grad_weight": bn.weight.grad,
                "grad_bias": bn.bias.grad, "running_mean": bn.running_mean.clone(),
                "running_var": bn.running_var.clone()}

    def single(bn, xi):  # TorchBatchNorm's train mode without a gang
        return torch.nn.functional.batch_norm(xi, bn.running_mean, bn.running_var, bn.weight,
                                              bn.bias, True, 0.1, bn.eps).to(torch.bfloat16)

    routes = {"fused": lambda bn, xi: bn(xi),
              "plain": lambda bn, xi: bn._global_batch_norm_plain(xi), "single_process": single}
    got = {name: run(copy.deepcopy(base), fwd) for name, fwd in routes.items()}
    rel = {ref: {k: float((got["fused"][k] - got[ref][k]).abs().max() / got[ref][k].abs().max())
                 for k in got[ref]} for ref in ("plain", "single_process")}
    for ref in rel:
        for k, tol in (("y", 2 ** -7), ("grad_x", 2 ** -7), ("grad_weight", 1e-3),
                       ("grad_bias", 1e-3), ("running_mean", 1e-4), ("running_var", 1e-4)):
            check(rel[ref][k] <= tol, f"the gang BN's fused {k} is off the {ref} BN: {rel}")
    xi = x.detach().clone().requires_grad_(True)
    times = {}
    for name, fwd in routes.items():
        bn = copy.deepcopy(base)
        times[f"{name}_ms"] = cuda_ms(torch, lambda: fwd(bn, xi).backward(dy), reps=10, warmup=3)
    return {"shape": list(x.shape), "fused_max_rel_err_against": rel, "forward_backward": times}


def _gang_step(torch, root, steps: int) -> dict:
    """The ResNet-50 train step at the path's batch (this rank's block of it
    in a gang), host clock around synchronized steps, and, in a gang of more
    than one rank, one all-reduce of a gradient's bytes (f32, every
    parameter); a 1-rank all-reduce exchanges nothing."""
    from daliid_tpu_torch.parallel import mesh

    dev = torch.device("cuda")
    trainer = _drill_trainer(torch, dev, root)
    pset = trainer.mine_proxies()
    put = lambda a: torch.as_tensor(a, device=dev)
    rest = (put(pset.centers), put(pset.proxies), put(pset.proxy_labels).long(), 1)
    images_u8, labels, dist, mask, _ = (t.to(dev) for t in trainer._stage(
        next(iter(trainer.sampler.epoch()))))
    step = lambda: trainer.train_step(images_u8, labels, dist, mask, *rest)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    out = {"ranks": mesh.world(), "gang": mesh.active(), "rows_per_rank": images_u8.shape[0],
           "step_ms": (time.time() - t0) / steps * 1e3}
    if mesh.world() > 1:
        grad = torch.ones(sum(p.numel() for p in trainer._params), device=dev)
        mesh.all_reduce_(grad)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(5):
            mesh.all_reduce_(grad)
        torch.cuda.synchronize()
        out["all_reduce_mb"] = grad.numel() * 4 / 1e6
        out["all_reduce_ms"] = (time.time() - t0) / 5 * 1e3
    del trainer
    return out


def gang_child(torch, spec_path: str) -> int:
    """One process of phase 20 (``chip_smoke.py --gang-child <spec>``): run
    the spec's commands in order, each with the launch counters at 0, and
    print each one's counts on a line of its own; results go to ``.npz``
    files beside the spec."""
    import importlib

    import numpy as np

    from daliid_tpu_torch.parallel import distributed, mesh

    spec = json.loads(Path(spec_path).read_text())
    out = Path(spec["out"])
    counts = Counts()
    init = distributed.initialize_multihost

    def timed_init(*a, **kw):  # the CLIs' --multihost goes through here
        t0 = time.time()
        info = init(*a, **kw)
        info["bootstrap_s"] = time.time() - t0
        return info

    distributed.initialize_multihost = timed_init
    for cmd in spec["commands"]:
        counts.reset()
        t0 = time.time()
        arrays = {}
        with _RecordExtract() as rec:
            if cmd["kind"] == "cli":
                module = importlib.import_module(f"daliid_tpu_torch.cli.{cmd['module']}")
                res = module.main(module.build_argparser().parse_args(cmd["argv"]))
                arrays = _cli_arrays(cmd["module"], res)
            elif cmd["kind"] == "join":
                info = distributed.initialize_multihost(cmd["address"], cmd["ranks"], 0)
                print(f"multihost: {info}", flush=True)
            elif cmd["kind"] == "grad":
                arrays = _first_step(torch, Path(cmd["root"]), cmd["dtype"])
            elif cmd["kind"] == "bn":
                print(f"[bn] {json.dumps(_gang_bn_check(torch))}", flush=True)
            else:
                print(f"[timing] {json.dumps({'tag': cmd['tag'], **_gang_step(torch, Path(cmd['root']), GANG_STEPS)})}",
                      flush=True)
        torch.cuda.synchronize()
        launched = counts.read()
        arrays.update({f"extract{i}": np.asarray(e) for i, e in enumerate(rec.out)
                       if not isinstance(e, tuple)})
        np.savez(out / f"{cmd['tag']}_rank{mesh.rank()}.npz", **arrays)
        print("[counts] " + json.dumps({"tag": cmd["tag"], "rank": mesh.rank(),
                                        "seconds": time.time() - t0, **launched}), flush=True)
    distributed.shutdown_multihost()
    return 0


def _gang_commands(root, bs: int, train_ckpt) -> list:
    """20b's commands: evaluate (bf16, sharded), evaluate int8, search SQ8
    and f32 at k = 10, the first train step's gradient (f32), one train
    epoch of 2 steps with its validation."""
    data = str(WORK / "data")
    ev = ["--targets", "Synthetic", "--data_root", data, "--model_name", "resnet50",
          "--compute_dtype", COMPUTE_DTYPE, "--sharded_eval", "--batch_size", str(bs),
          *_img_flags()]
    se = ["--dataset", "Synthetic", "--data_root", data, "--model_name", "resnet50",
          "--compute_dtype", COMPUTE_DTYPE, "--topk", "10", "--batch_size", str(bs),
          *_img_flags()]
    return [{"kind": "cli", "module": "evaluate", "tag": "evaluate_bf16", "argv": ev},
            {"kind": "cli", "module": "evaluate", "tag": "evaluate_int8",
             "argv": ev + ["--quantize", "int8"]},
            {"kind": "cli", "module": "search", "tag": "search_sq8",
             "argv": se + ["--index_quantize", "int8"]},
            {"kind": "cli", "module": "search", "tag": "search_f32", "argv": se},
            {"kind": "grad", "tag": "grad", "root": str(root), "dtype": "float32"},
            {"kind": "cli", "module": "train", "tag": "train",
             "argv": _train_flags(root, train_ckpt, 1, eval_freq=1)}]


# what each command of 20b must launch, on every rank
GANG_EXPECT = {"evaluate_bf16": ("rank_counts",), "evaluate_int8": ("rank_counts", "conv_int8"),
               "search_sq8": ("search_topk_sq8",), "search_f32": ("search_topk_f32",),
               "grad": ("fused_augment",), "train": ("fused_augment", "rank_counts")}


def _parse_lines(text: str, prefix: str) -> list:
    return [json.loads(line[len(prefix):]) for line in text.splitlines()
            if line.startswith(prefix)]


def _multihost_infos(text: str) -> list:
    """Every ``multihost: {...}`` line of ``text``, as dicts."""
    import ast

    return [ast.literal_eval(line[len("multihost: "):]) for line in text.splitlines()
            if line.startswith("multihost: ")]


def _multihost_info(text: str) -> dict:
    """The one ``multihost: {...}`` line a process printed, as a dict."""
    infos = _multihost_infos(text)
    check(len(infos) == 1, f"expected one multihost line, got {infos}")
    return infos[0]


def _child_cmd(spec) -> list:
    return [sys.executable, str(REPO / "chip_smoke.py"), "--gang-child", str(spec)]


def _cosines(a, b):
    import numpy as np

    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-12)


def phase_gang(torch, dev, root, counts) -> tuple:
    """20b: two ranks on the one card (gloo) against one process, and the
    timing processes: the plain step and the 1-rank NCCL gang in one
    process, the 2-rank gloo step in the gang."""
    import numpy as np

    from daliid_tpu_torch.cli import evaluate, search, train

    out = WORK / "gang"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    addr = f"127.0.0.1:{_free_port()}"
    cmds = []
    for r in range(2):
        commands = _gang_commands(root, 512, WORK / "gang_train")
        commands[0]["argv"] += ["--multihost", "--coordinator_address", addr,
                                "--num_processes", "2", "--process_id", str(r)]
        commands.append({"kind": "timing", "tag": "timing_gloo", "root": str(root)})
        spec = out / f"rank{r}.json"
        spec.write_text(json.dumps({"out": str(out), "commands": commands}))
        cmds.append(_child_cmd(spec))
    t0 = time.time()
    texts = _run_children(cmds, "gang", 900)
    gang_s = time.time() - t0
    launched = {name: 0 for name in KERNELS}
    for r, text in enumerate(texts):
        info = _multihost_info(text)
        check(info["backend"] == "gloo" and info["device"] == "cuda:0"
              and info["process_index"] == r, f"rank {r} did not join a gloo gang: {info}")
        rows = {row["tag"]: row for row in _parse_lines(text, "[counts] ")}
        for tag, kernels in GANG_EXPECT.items():
            for k in kernels:
                check(rows[tag][k] > 0, f"rank {r}'s {tag} launched no {k}: {rows[tag]}")
        check(rows["train"]["fused_augment"] == 2, f"rank {r} trained {rows['train']} steps")
        check(rows["evaluate_bf16"]["conv_int8"] == 0, "the float evaluate launched conv_int8")
        for row in rows.values():
            for name in launched:
                launched[name] += row[name]
    bootstrap = _multihost_info(texts[0])["bootstrap_s"]
    timing_gloo = _parse_lines(texts[0], "[timing] ")[0]
    per_tag = {r: {row["tag"]: row for row in _parse_lines(t, "[counts] ")}
               for r, t in enumerate(texts)}

    # the same commands as one process, here, at half the batch: each rank's
    # forward batch, so both sides convolve the same images together
    one = WORK / "one"
    shutil.rmtree(one, ignore_errors=True)
    one.mkdir()
    shutil.rmtree(WORK / "one_train", ignore_errors=True)
    shutil.rmtree(WORK / "one_train_metrics", ignore_errors=True)
    modules = {"evaluate": evaluate, "search": search, "train": train}
    for cmd in _gang_commands(root, 256, WORK / "one_train"):
        counts.reset()
        if cmd["kind"] == "grad":
            arrays = _first_step(torch, root, cmd["dtype"])
            with _NativeBatchNorm():  # the floor: one process against itself
                np.savez(one / "grad_native.npz", **_first_step(torch, root, cmd["dtype"]))
        else:
            module = modules[cmd["module"]]
            with _RecordExtract() as rec:
                res = module.main(module.build_argparser().parse_args(cmd["argv"]))
            arrays = {**_cli_arrays(cmd["module"], res),
                      **{f"extract{i}": np.asarray(e) for i, e in enumerate(rec.out)}}
        for name, n in counts.read().items():
            launched[name] += n
        np.savez(one / f"{cmd['tag']}.npz", **arrays)
    report = {"gang_s": gang_s, "bootstrap_gloo_s": bootstrap, "timing_gloo": timing_gloo,
              "seconds": {tag: [per_tag[r][tag]["seconds"] for r in range(2)]
                          for tag in per_tag[0]}}
    for tag in ("evaluate_bf16", "evaluate_int8", "search_sq8", "search_f32"):
        ranks = [np.load(out / f"{tag}_rank{r}.npz") for r in range(2)]
        want = np.load(one / f"{tag}.npz")
        for key in ranks[0].files:
            check(np.array_equal(ranks[0][key], ranks[1][key]), f"{tag}: the ranks' {key} differ")
        got = ranks[0]
        if tag.startswith("evaluate"):
            check(np.array_equal(got["cmc"], want["cmc"]), f"{tag}: CMC differs from one process")
            check(abs(float(got["map"][0]) - float(want["map"][0])) <= 1e-12,
                  f"{tag}: mAP {got['map']} != one process's {want['map']}")
        else:
            check(np.array_equal(got["ids"], want["ids"]), f"{tag}: ids differ from one process")
            if tag == "search_sq8":
                check(np.array_equal(got["sims"], want["sims"]),
                      f"{tag}: SQ8 scores differ from one process")
        cos = min(float(_cosines(got[f"extract{i}"], want[f"extract{i}"]).min())
                  for i in range(2))
        check(cos >= (0.998 if tag == "evaluate_int8" else 0.999),
              f"{tag}: embeddings off one process's, min cosine {cos}")
        report[tag] = {"min_cosine": cos, "embeddings_bit_equal": all(
            np.array_equal(got[f"extract{i}"], want[f"extract{i}"]) for i in range(2)),
            "max_abs_score_diff": (float(np.abs(got["sims"] - want["sims"]).max())
                                   if "sims" in got.files else None)}
    # the first step up to Adam: the summed gradient and the BN updates
    ranks = [np.load(out / f"grad_rank{r}.npz") for r in range(2)]
    want, native = np.load(one / "grad.npz"), np.load(one / "grad_native.npz")
    check(np.array_equal(ranks[0]["grad"], ranks[1]["grad"]), "grad: the ranks' gradients differ")
    g, w = ranks[0]["grad"].astype(np.float64), want["grad"].astype(np.float64)
    floor = native["grad"].astype(np.float64)
    step = {"grad_rel_l2": float(np.linalg.norm(g - w) / np.linalg.norm(w)),
            "floor_rel_l2": float(np.linalg.norm(floor - w) / np.linalg.norm(w)),
            "grad_norm_ratio": float(np.linalg.norm(g) / np.linalg.norm(w)), "bn_leaves": 0,
            "bn_update_max_rel_to_largest": 0.0}
    for key in (k for k in want.files if k.startswith("bn")):
        d = float(np.abs(ranks[0][key] - want[key]).max() / max(np.abs(want[key]).max(), 1e-30))
        step["bn_leaves"] += 1
        step["bn_update_max_rel_to_largest"] = max(step["bn_update_max_rel_to_largest"], d)
    log(f"20b first step (f32), 2 gloo ranks against one process: {json.dumps(step)}")
    check(step["grad_rel_l2"] <= GRAD_L2_TOL, f"the gang's first gradient is off one process's: {step}")
    check(step["bn_leaves"] > 50 and step["bn_update_max_rel_to_largest"] <= BN_STEP_TOL,
          f"the gang's first BN updates are off one process's: {step}")
    report["first_step_vs_one_process"] = step
    a = torch.load(WORK / "gang_train" / "latest" / "1.pt", weights_only=True)
    b = torch.load(WORK / "one_train" / "latest" / "1.pt", weights_only=True)
    trained = _state_diff(torch, a["state"], b["state"])
    ratios = [trained[k]["norm_ratio"] for k in ("adam_m", "adam_v")]
    check(trained["params"]["max_abs_diff"] <= ADAM_PART * 2
          and trained["bn_stats"]["rel_l2"] <= BN_EPOCH_TOL
          and trained["adam"]["bit_equal"] == trained["adam"]["leaves"]
          and all(1 / MOMENT_NORM_FACTOR <= r <= MOMENT_NORM_FACTOR for r in ratios),
          f"the gang's trained state is off one process's: {trained}")
    report["train_vs_one_process"] = trained

    # the plain single-process step and the 1-rank NCCL gang, one process
    spec = out / "timing.json"
    spec.write_text(json.dumps({"out": str(out), "commands": [
        {"kind": "timing", "tag": "timing_plain", "root": str(root)},
        {"kind": "join", "tag": "join", "address": f"127.0.0.1:{_free_port()}", "ranks": 1},
        {"kind": "bn", "tag": "bn"},
        {"kind": "timing", "tag": "timing_nccl", "root": str(root)}]}))
    text = _run_children([_child_cmd(spec)], "timing", 600)[0]
    info = _multihost_info(text)
    check(info["backend"] == "nccl", f"the 1-rank timing gang did not run on NCCL: {info}")
    timings = {row["tag"]: row for row in _parse_lines(text, "[timing] ")}
    report["timing_plain"], report["timing_nccl"] = timings["timing_plain"], timings["timing_nccl"]
    report["gang_bn"] = _parse_lines(text, "[bn] ")[0]
    report["bootstrap_nccl_s"] = info["bootstrap_s"]
    log(f"20b two ranks on one card (gloo) against one process: {json.dumps(report)}")
    log(f"20b gang launches (both ranks) and the one-process runs: {launched}")
    return launched, report


def _exact_embeddings(torch, gen, dev, n_ids: int, *pid_sets, d: int = 2048, nnz: int = 64,
                      chunk: int = 8192) -> list:
    """For each array of pids, (N, d) rows of +-1 at exactly ``nnz``
    coordinates: every norm is 8 and every dot product an integer, so each
    cosine distance ``1 - dot / 64`` is exact in f32 whatever order a product
    sums in (the chunked and the whole distance matrix agree bit for bit,
    many at exact ties). A row takes the first k (0-24) coordinates of its
    identity's order with their signs, and random ones for the rest."""
    id_rank = torch.rand((n_ids, d), generator=gen, device=dev).argsort(dim=1).argsort(dim=1)
    id_rank = id_rank.to(torch.int16)
    id_sign = torch.randint(0, 2, (n_ids, d), generator=gen, device=dev).float() * 2 - 1
    sets = []
    for pids in pid_sets:
        p_all = torch.as_tensor(pids, dtype=torch.long, device=dev)
        out = torch.zeros((p_all.numel(), d), device=dev)
        for s in range(0, p_all.numel(), chunk):
            p = p_all[s:s + chunk]
            n = p.numel()
            rank = id_rank[p].int()
            k = torch.randint(0, 25, (n, 1), generator=gen, device=dev)
            keys = torch.rand((n, d), generator=gen, device=dev)
            keys = torch.where(rank < k, -1.0, torch.where(rank < nnz, 2.0, keys))
            cols = keys.topk(nnz, dim=1, largest=False).indices
            own = rank.gather(1, cols) < k
            other = torch.randint(0, 2, (n, nnz), generator=gen, device=dev).float() * 2 - 1
            out[s:s + n].scatter_(1, cols, torch.where(own, id_sign[p].gather(1, cols), other))
        sets.append(out)
    return sets


def phase_bounded_ranking(torch, dev, counts) -> tuple:
    """20c: ``evaluate_rank_sharded`` on one process at MSMT17's protocol
    shape, query_chunk 512, against the replicated ``evaluate_rank`` on the
    whole distmat; K2 at the chunk shape against its plain version."""
    import numpy as np

    from daliid_tpu_torch.metrics.ranking import (
        _positive_prologue,
        cosine_distance_matrix,
        evaluate_rank,
        evaluate_rank_sharded,
        positive_columns,
        queried_positives_bound,
    )
    from daliid_tpu_torch.ops.rank_counts import positive_rank_counts, rank_counts_plain

    q_pids, g_pids, q_cams, g_cams = msmt17_ids()
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    n_ids = int(max(q_pids.max(), g_pids.max())) + 1
    q, g = _exact_embeddings(torch, gen, dev, n_ids, q_pids, g_pids)
    runs = {}
    for route in ("sharded", "replicated"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        counts.reset()
        t0 = time.time()
        if route == "sharded":
            cmc, mAP = evaluate_rank_sharded(q, g, q_pids, g_pids, q_cams, g_cams,
                                             query_chunk=RANK_CHUNK)
        else:
            cmc, mAP = evaluate_rank(cosine_distance_matrix(q, g), q_pids, g_pids, q_cams,
                                     g_cams)
        torch.cuda.synchronize()
        runs[route] = {"ms": (time.time() - t0) * 1e3, "cmc": cmc, "map": mAP,
                       "peak_gb_above_inputs": (torch.cuda.max_memory_allocated(dev) - base) / 1e9,
                       "k2_launches": counts.read()["rank_counts"]}
    launched = {name: 0 for name in KERNELS}
    launched["rank_counts"] = runs["sharded"]["k2_launches"] + runs["replicated"]["k2_launches"]
    n_chunks = -(-len(q_pids) // RANK_CHUNK)
    check(runs["sharded"]["k2_launches"] == n_chunks,
          f"the sharded ranking launched K2 {runs['sharded']['k2_launches']} times, not {n_chunks}")
    check(np.array_equal(runs["sharded"]["cmc"], runs["replicated"]["cmc"]),
          "the bounded-memory CMC differs from the replicated one")
    check(abs(runs["sharded"]["map"] - runs["replicated"]["map"]) <= 1e-12,
          f"bounded-memory mAP {runs['sharded']['map']} != replicated {runs['replicated']['map']}")
    # K2 at the chunk shape against its plain version (not counted)
    n_p = queried_positives_bound(q_pids, g_pids)
    qn, gn = (x / torch.linalg.norm(x, dim=1, keepdim=True) for x in (q[:RANK_CHUNK], g))
    dist = 1.0 - qn @ gn.T
    ids = [torch.as_tensor(a[:RANK_CHUNK] if i < 2 else a, dtype=torch.int32, device=dev)
           for i, a in enumerate((q_pids, q_cams, g_pids, g_cams))]
    cols = torch.as_tensor(positive_columns(q_pids[:RANK_CHUNK], g_pids, n_p), device=dev)
    _, _, p_dist, p_idx = _positive_prologue(dist, cols, ids[1], ids[3], False)
    args = (dist, p_dist, p_idx, ids[0], ids[1], ids[2], ids[3])
    check(torch.equal(positive_rank_counts(*args), rank_counts_plain(*args)),
          "K2 differs from its plain version at the chunk shape")
    counts.reset()
    report = {route: {k: v for k, v in r.items() if k != "cmc"} for route, r in runs.items()}
    report["rank1"] = float(runs["sharded"]["cmc"][0])
    report["chunk_shape"] = [RANK_CHUNK, len(g_pids), n_p]
    log(f"20c bounded-memory ranking at MSMT17's shape (Q {len(q_pids)}, G {len(g_pids)}, "
        f"2048-d, query_chunk {RANK_CHUNK}): {json.dumps(report)}; K2 equal to its plain "
        f"version at ({RANK_CHUNK}, {len(g_pids)}) P {n_p}")
    del q, g, dist
    torch.cuda.empty_cache()
    return launched, report


# ---------------------------------------------------------------- phase 21
REMAT_CLI = (("transreid_jpm", "full"), ("vit", "tuned"))
# the losses of phase 21d: values within this relative tolerance of the
# CPU's, gradients within rtol 1e-4 plus 1e-6 of their largest entry (the
# limits of tests/test_torch_losses.py); the card's f32 products sum in
# another order than the CPU's
LOSS_RTOL = 1e-5


def set_remat(module, mode: str) -> None:
    """Checkpoint every transformer block of ``module`` per ``mode``."""
    from daliid_tpu_torch.models.vit import Block, check_remat

    for m in module.modules():
        if isinstance(m, Block):
            m.remat = check_remat(mode)


def _remat_cli(torch, root, counts) -> dict:
    """21a: ``cli.train.main`` with ``--remat full`` (JPM) and ``--remat
    tuned`` (ViT-B), one epoch of 2 steps and its validation each (the CLIs
    attend through SDPA); ``--remat full`` with ResNet-50 refused."""
    import numpy as np

    from daliid_tpu_torch.cli import train

    steps = TRAIN_IDS // P
    total = {}
    for name, mode in REMAT_CLI:
        ckpt, metrics = WORK / f"remat_{name}_ckpt", WORK / f"remat_{name}_metrics"
        extra = ["--num_classes", "-1"] if name == "transreid_jpm" else []
        args = train.build_argparser().parse_args(
            ["--dataset", "Synthetic", "--data_root", str(root), "--model_name", name,
             "--remat", mode, *extra, "--compute_dtype", COMPUTE_DTYPE, "--kind_of_transform",
             "1", "--P", str(P), "--K", str(K), "--epochs", "1", "--eval_freq", "1",
             "--skip_initial_eval", "--path_to_save_models", str(ckpt),
             "--path_to_save_metrics", str(metrics), *_img_flags()])
        counts.reset()
        t0 = time.time()
        train.main(args)
        seconds = time.time() - t0
        launched = counts.read()
        check(launched["fused_augment"] == steps and launched["rank_counts"] > 0,
              f"train --model_name {name} --remat {mode} launched {launched}")
        progress = json.loads((metrics / f"progress_{name}_v0.json").read_text())
        check(len(progress) == 1 and all(np.isfinite(progress[0][k]) for k in ("loss", "rank1")),
              f"train --remat {mode} ({name}) progress {progress}")
        log(f"21a train CLI --model_name {name} --remat {mode} (bf16, SDPA): 1 epoch of {steps} "
            f"steps and its validation in {seconds:.1f} s, loss {progress[0]['loss']:.5f}; "
            f"launches {launched}")
        for k, n in launched.items():
            total[k] = total.get(k, 0) + n
    args = train.build_argparser().parse_args(
        ["--dataset", "Synthetic", "--data_root", str(root), "--remat", "full", *_img_flags()])
    try:
        train.main(args)
        fail("train --model_name resnet50 --remat full was not refused")
    except SystemExit as e:
        check("only applies to the transformer family" in str(e),
              f"train --model_name resnet50 --remat full: {e}")
        log(f"21a train --model_name resnet50 --remat full refused: {e}")
    return total


def _export_args(name: str, src: str, dst: str, *extra):
    from daliid_tpu_torch.cli import export

    return export.build_argparser().parse_args(
        ["--model_name", name, "--input", src, "--output", dst, *extra, *_img_flags()])


def _export_round_trip(torch, name: str, pt: Path, *extra) -> dict:
    """21b: ``pt`` → ``export`` → .npz → ``export`` → .pth, bit-equal to
    ``pt`` over its keys; → the two directions' seconds and the paths."""
    from daliid_tpu_torch.cli import export
    from daliid_tpu_torch.models.torch_port import load_torch_checkpoint

    npz, pth = WORK / f"export_{name}.npz", WORK / f"export_{name}.pth"
    t0 = time.time()
    export.main(_export_args(name, str(pt), str(npz), *extra))
    t1 = time.time()
    export.main(_export_args(name, str(npz), str(pth), *extra))
    t2 = time.time()
    src, out = load_torch_checkpoint(str(pt)), torch.load(pth, weights_only=True)
    check(set(out) == set(src), f"export {name}: keys differ: {sorted(set(out) ^ set(src))[:6]}")
    bad = [k for k in src if not torch.equal(out[k], src[k].float())]
    check(not bad, f"export {name}: tensors differ after the round trip: {bad[:6]}")
    return {"to_npz_s": t1 - t0, "to_torch_s": t2 - t1, "keys": len(src),
            "mb": sum(v.numel() * 4 for v in src.values()) / 1e6, "npz": str(npz)}


def _export_phase(torch, counts) -> tuple:
    """21b: the export round trips of the ResNet-50 and JPM checkpoints that
    phases 8 and 11 wrote; ``evaluate`` on the ResNet-50 .npz gives the .pt's
    CMC and mAP; ``multipart_resnet50`` to a torch pickle is refused."""
    import numpy as np

    from daliid_tpu_torch.cli import evaluate

    resnet_pt = WORK / "train_ckpt" / "model_online_resnet50_v0.pt"
    jpm_pt = WORK / "jpm_ckpt" / "model_online_transreid_jpm_v0.pt"
    report = {"resnet50": _export_round_trip(torch, "resnet50", resnet_pt),
              "transreid_jpm": _export_round_trip(torch, "transreid_jpm", jpm_pt,
                                                  "--num_classes", str(TRAIN_IDS))}
    results, total = {}, {}
    for path in (str(resnet_pt), report["resnet50"]["npz"]):
        args = evaluate.build_argparser().parse_args(
            ["--targets", "Synthetic", "--model_name", "resnet50", "--model_path", path,
             *_eval_flags()])
        counts.reset()
        results[path] = evaluate.main(args)["Synthetic"]
        launched = counts.read()
        check(launched["rank_counts"] == 1, f"evaluate --model_path {path} launched {launched}")
        for k, n in launched.items():
            total[k] = total.get(k, 0) + n
    (cmc_pt, map_pt), (cmc_npz, map_npz) = results.values()
    check(np.array_equal(cmc_pt, cmc_npz) and map_pt == map_npz,
          f"evaluate on the exported .npz: R1 {cmc_npz[0]} mAP {map_npz} against the .pt's "
          f"R1 {cmc_pt[0]} mAP {map_pt}")
    from daliid_tpu_torch.cli import export

    try:
        export.main(_export_args("multipart_resnet50", report["resnet50"]["npz"],
                                 str(WORK / "export_multipart.pth")))
        fail("export of multipart_resnet50 to a torch pickle was not refused")
    except SystemExit as e:
        check("upper_bn" in str(e) and ".npz" in str(e), f"export multipart_resnet50: {e}")
    log(f"21b export round trips (.pt -> .npz -> .pth, bit-equal): {json.dumps(report)}; "
        f"evaluate on the .npz: R1 {cmc_npz[0]:.4f} mAP {map_npz:.6f}, equal to the .pt's; "
        f"multipart_resnet50 -> .pth refused")
    return total, report


def _subset_phase(torch, dev, root, counts) -> tuple:
    """21c: ``mine_subset`` of the train set's first row with two extractors,
    ResNet-50 and JPM on K4 (bf16, the checkpoints of phases 8 and 11): the
    row itself first, K4 launched as often as the JPM extraction's forwards
    need."""
    import numpy as np

    from daliid_tpu_torch.cli.evaluate import load_bundle
    from daliid_tpu_torch.data import load_dataset
    from daliid_tpu_torch.eval.features import FeatureExtractor
    from daliid_tpu_torch.eval.subset import mine_subset

    table = load_dataset("Synthetic", root=str(root))["train"]
    extractors = [FeatureExtractor(
        load_bundle(name, str(path), IMG, torch.bfloat16, dev, **kw), img_size=IMG,
        batch_size=EXTRACT_BATCH, device=dev) for name, path, kw in (
            ("resnet50", WORK / "train_ckpt" / "model_online_resnet50_v0.pt", {}),
            ("transreid_jpm", WORK / "jpm_ckpt" / "model_online_transreid_jpm_v0.pt",
             {"use_fused_attention": True}))]
    top_k = len(table) // 4
    counts.reset()
    t0 = time.time()
    sel, rest = mine_subset(table[np.arange(1)], table, extractors, top_k=top_k)
    seconds = time.time() - t0
    launched = counts.read()
    forwards = 1 + _forwards(table)
    check(launched["flash_attention"] == K4_PER_FORWARD["transreid_jpm"] * forwards,
          f"mine_subset launched K4 {launched['flash_attention']} times for {forwards} JPM "
          f"forwards")
    check(len(sel) == top_k and len(rest) == len(table) - top_k
          and sorted(np.concatenate([sel, rest]).tolist()) == list(range(len(table))),
          f"mine_subset split {len(sel)} + {len(rest)} rows of {len(table)}")
    check(sel[0] == 0, f"mine_subset ranked row {sel[0]} before the selected row 0")
    same_id = float(np.mean(table.pids[sel[1:]] == table.pids[0]))
    log(f"21c mine_subset (ResNet-50 + JPM on K4, bf16) of row 0 over {len(table)} train rows: "
        f"top {top_k} in {seconds:.2f} s, the row itself first, {100 * same_id:.1f}% of the rest "
        f"of the top its identity's; launches {launched}")
    del extractors
    return launched, {"seconds": seconds, "top_k": top_k, "same_identity_share": same_id}


def _loss_cases(torch, L, M, proxies_mod, dev):
    """21d: the inputs, a PK batch of 384 x 2048 (16 identities x 24, paired
    clean and distorted slots, the last pair masked), made on the host from
    seed 21 and copied to ``dev``; → {name: loss of the embeddings}."""
    import numpy as np

    rng = np.random.default_rng(21)
    n, d, ids = 2 * P * K, 2048, P
    labels = np.repeat(np.arange(ids), n // ids).astype(np.int64)
    base = rng.normal(size=(ids, d))
    fvs = base[labels] + 1.5 * rng.normal(size=(n, d))
    fvs = (fvs / np.linalg.norm(fvs, axis=1, keepdims=True)).astype(np.float32)
    dist = np.stack([np.zeros(n // 2), rng.integers(1, 6, n // 2)], 1).reshape(-1)
    mask = np.ones(n, bool)
    mask[-2:] = False
    cams = rng.integers(0, 6, n)
    clothes = rng.integers(0, 3, n)
    controlled = rng.random(n) < 0.3
    unit = lambda a: (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)
    centers = unit(base)
    proxies = unit(base[np.repeat(np.arange(ids), 5)] + rng.normal(size=(5 * ids, d)))
    plabels = np.repeat(np.arange(ids), 5)
    plabels[::7] = -1
    cc, cids, ccams = proxies_mod.mine_camera_centers(fvs, labels, cams)
    heads = rng.normal(size=(d, ids)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)
    lab, dst, msk, cam, clo = t(labels), t(dist.astype(np.int64)), t(mask), t(cams), t(clothes)
    e, ne = 3.0, 10.0
    cases = {
        "center_loss": lambda f: L.center_loss(f, lab, t(centers), sample_mask=msk),
        "l2_center_loss": lambda f: L.l2_center_loss(f, lab, t(centers), sample_mask=msk),
        "proxy_loss": lambda f: L.proxy_loss(f, lab, t(proxies), t(plabels), p_max=5),
        "weighted_softmax_all_triplet_loss": lambda f: L.weighted_softmax_all_triplet_loss(
            f, lab, dst, e, ne, sample_mask=msk),
        "weighted_all_positive_cosine_loss": lambda f: L.weighted_all_positive_cosine_loss(
            f, lab, dst, e, ne, sample_mask=msk),
        "softmax_all_triplet_loss": lambda f: L.softmax_all_triplet_loss(
            f, lab, dst, e, ne, sample_mask=msk),
        "multi_level_distortion_loss": lambda f: L.multi_level_distortion_loss(f[:n // 6], f),
        "instance_loss": lambda f: L.instance_loss(f),
        "hard_center_triplet_loss": lambda f: L.hard_center_triplet_loss(
            f, lab, t(centers), sample_mask=msk),
        "clothes_triplet_loss": lambda f: L.clothes_triplet_loss(f, lab, clo, sample_mask=msk),
        "bipartite_loss": lambda f: torch.stack(L.bipartite_loss(
            f, lab, cam, clo, dst, e, ne, sample_mask=msk, controlled=t(controlled))),
        "weighted_pose_loss": lambda f: L.weighted_pose_loss(
            f, lab, cam, clo, dst, e, ne, sample_mask=msk),
        "controlled_camera_hard_loss": lambda f: L.controlled_camera_hard_loss(
            f, lab, dst, e, ne, sample_mask=msk),
        "camera_hard_loss": lambda f: L.camera_hard_loss(
            f, lab, cam, t(cc), t(cids), t(ccams), sample_mask=msk),
        "median_softmax_triplet_loss": lambda f: L.median_softmax_triplet_loss(
            f, lab, sample_mask=msk),
    }
    for kind in ("arcface", "cosface", "amsoftmax", "circle"):
        cases[f"margin_softmax_loss[{kind}]"] = (
            lambda f, kind=kind: M.margin_softmax_loss(kind, f, t(heads), lab, sample_mask=msk))
    return fvs, cases


def _losses_phase(torch, dev) -> dict:
    """21d: each loss of the library that no train step takes, and
    ``margin_softmax_loss`` for the four heads, on the card against the same
    call on the CPU: values within ``LOSS_RTOL``, gradients within rtol 1e-4
    plus 1e-6 of their largest entry."""
    import numpy as np

    from daliid_tpu_torch import losses as L
    from daliid_tpu_torch import margins as M
    from daliid_tpu_torch.train import proxies

    worst, results = {}, {}
    for where in (dev, torch.device("cpu")):
        fvs, cases = _loss_cases(torch, L, M, proxies, where)
        for name, fn in cases.items():
            f = torch.as_tensor(fvs, device=where).requires_grad_(True)
            value = fn(f)
            value.sum().backward()
            results.setdefault(name, []).append((value.detach().cpu().numpy(),
                                                 f.grad.cpu().numpy()))
    for name, ((v_gpu, g_gpu), (v_cpu, g_cpu)) in results.items():
        check(np.isfinite(v_gpu).all() and np.isfinite(g_gpu).all(), f"{name}: not finite")
        v_err = float(np.max(np.abs(v_gpu - v_cpu) / np.maximum(np.abs(v_cpu), 1e-30)))
        scale = float(np.abs(g_cpu).max())
        g_err = float(np.max(np.abs(g_gpu - g_cpu) / (1e-4 * np.abs(g_cpu) + 1e-6 * scale)))
        check(v_err <= LOSS_RTOL, f"{name}: value {v_gpu} on the card, {v_cpu} on the CPU")
        check(g_err <= 1.0, f"{name}: gradient off by {g_err:.3g} of its limit")
        worst[name] = {"value": float(np.sum(v_gpu)), "value_rel_err": v_err,
                       "grad_err_of_limit": g_err}
    log(f"21d losses at a PK batch of {2 * P * K} x 2048 on the card against the CPU (value "
        f"rtol {LOSS_RTOL}; gradient rtol 1e-4 + 1e-6 of the largest): {json.dumps(worst)}")
    return worst


def phase_remainder(torch, dev, root, counts) -> tuple:
    """Phase 21: the train CLI under ``--remat`` (21a), ``export`` (21b),
    ``mine_subset`` (21c) and the losses on the card (21d); the remat step's
    times, gradients and trace (21a, 21e) are in ``_time_jpm``."""
    launched = _remat_cli(torch, root, counts)
    exported, export_report = _export_phase(torch, counts)
    mined, subset_report = _subset_phase(torch, dev, root, counts)
    for got in (exported, mined):
        for k, n in got.items():
            launched[k] = launched.get(k, 0) + n
    report = {"export": export_report, "subset": subset_report,
              "losses": _losses_phase(torch, dev)}
    torch.cuda.empty_cache()
    return launched, report


# ---------------------------------------------------------------- counts
class Counts:
    """The launch counters of every kernel wrapper on the main path."""

    def __init__(self):
        from daliid_tpu_torch.ops.conv_int8 import conv_int8
        from daliid_tpu_torch.ops.flash_attention import flash_attention
        from daliid_tpu_torch.ops.fused_augment import fused_augment
        from daliid_tpu_torch.ops.rank_counts import positive_rank_counts
        from daliid_tpu_torch.ops.search_topk import f32_search_topk, sq8_search_topk

        self.wrappers = {"rank_counts": positive_rank_counts,
                         "search_topk_sq8": sq8_search_topk,
                         "search_topk_f32": f32_search_topk,
                         "fused_augment": fused_augment,
                         "flash_attention": flash_attention,
                         "conv_int8": conv_int8}

    def reset(self):
        for w in self.wrappers.values():
            w.launches = 0

    def read(self) -> dict:
        return {name: w.launches for name, w in self.wrappers.items()}


KERNELS = {
    "rank_counts": {"source": "daliid_tpu_torch/csrc/rank_counts.cu",
                    "replaces": "daliid_tpu/ops/rank_counts.py:104", "check": "exact counts"},
    "search_topk_sq8": {"source": "daliid_tpu_torch/csrc/search_topk.cu",
                        "replaces": "daliid_tpu/ops/search_topk.py:119", "check": "bit-exact"},
    "search_topk_f32": {"source": "daliid_tpu_torch/csrc/search_topk.cu",
                        "replaces": "daliid_tpu/ops/search_topk.py:119",
                        "check": "vals rtol 1e-5, equal index sets"},
    "fused_augment": {"source": "daliid_tpu_torch/csrc/fused_augment.cu",
                      "replaces": "daliid_tpu/ops/fused_augment.py:153",
                      "check": "f32 atol 2e-5; bf16 one bf16 ulp (or 2e-5)"},
    "flash_attention": {"source": "daliid_tpu_torch/csrc/flash_attention.cu",
                        "replaces": "daliid_tpu/ops/flash_attention.py:55",
                        "check": "f32 atol 2e-5; bf16 one bf16 ulp (or 2e-5); "
                                 "backward f32 atol 3e-5"},
    # a kernel of the port alone: the JAX package runs these convolutions
    # through XLA (lax.conv_general_dilated on int8), no Pallas kernel
    "conv_int8": {"source": "daliid_tpu_torch/csrc/conv_int8.cu",
                  "replaces": "daliid_tpu/ops/quantize.py:278 (XLA int8 convolution; no "
                              "Pallas kernel)",
                  "check": "bit-exact (int32, f32 and bf16 out)",
                  "library": "none: no one PyTorch call computes it (quantize_sym + "
                             "F.unfold + torch._int_mm, groups = 1, in im2col_int_mm_ms)"},
}


# the kernels each timed wrapper launches on the main path, for their
# ptxas report: K4 bf16 takes 8 warps a block at N = 211, 4 at N = 53 and 129
PATH_KERNELS = {"rank_counts": ("rank_counts_kernel",),
                "fused_augment": ("fused_augment_kernel<__nv_bfloat16>",),
                "search_topk_sq8": ("topk_pass1<1>", "topk_pass2"),
                "search_topk_f32": ("topk_pass1<0>", "topk_pass2"),
                "flash_attention": ("attention_mma<64,8>", "attention_mma<64,4>"),
                # the bf16 path's kernels: the gathering implicit GEMM (1x1
                # convolutions), the staged window (the stems and k x k), depthwise
                "conv_int8": tuple(f"conv_wgmma<__nv_bfloat16,{bn},{staged},{nwg}>"
                                   for staged, nwg in ((0, 2), (1, 2), (1, 1))
                                   for bn in (32, 64, 128, 256))
                + tuple(f"conv_dw<__nv_bfloat16,{k},{k},{s}>" for k in (3, 5) for s in (1, 2))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this script needs one GPU", flush=True)
        return 2
    if not (REPO / "daliid_tpu_torch" / "__init__.py").exists():
        print("[chip_smoke] daliid_tpu_torch not found beside chip_smoke.py", flush=True)
        return 2
    if sys.argv[1:2] == ["--kernel-times"]:
        root, ps = sys.argv[2], [int(x) for x in sys.argv[3].split(",")]
        print(json.dumps(kernel_times(torch, root, ps, json.loads(sys.argv[4]))), flush=True)
        return 0
    sys.path.insert(0, str(REPO))
    if sys.argv[1:2] == ["--gang-child"]:
        return gang_child(torch, sys.argv[2])
    if sys.argv[1:2] == ["--compare"]:
        _, dev, _ = phase_device(torch)
        geos = {" ".join(key): geo for key, geo in conv_shapes(torch, dev).items()}
        print(json.dumps({"compare": compare(sys.argv[2], geos)}), flush=True)
        return 0
    t_start = time.time()
    card, dev, ptxas = phase_device(torch)
    decoder = loader_status()
    splits = make_dataset()
    n_g, n_q = len(splits["gallery"]), len(splits["query"])
    capacity = 1 << (n_g - 1).bit_length()
    from daliid_tpu_torch.metrics.ranking import queried_positives_bound

    phase_k2(torch, dev, (n_q, n_g, queried_positives_bound(splits["query"].pids,
                                                            splits["gallery"].pids)))
    f32_err = phase_k3(torch, dev, (n_q, capacity, 2048, n_g))
    k1_err = phase_k1(torch, dev)
    k4_err, k4_bwd_err = phase_k4(torch, dev)
    shapes = conv_shapes(torch, dev)
    conv_err = phase_conv_int8(torch, dev, shapes)
    train_root = make_train_dataset()

    counts = Counts()
    launches = {name: 0 for name in KERNELS}
    walls = {}

    def timed(name, phase):
        launched, walls[name] = phase()
        return launched

    def walled(phase):
        launched, phase_walls = phase()
        walls.update(phase_walls)
        return launched

    fp_phases = (lambda: phase_serve(torch, splits, counts)[0],
                  lambda: phase_search(torch, counts),
                  lambda: phase_evaluate(torch, counts),
                  lambda: phase_train(torch, counts, train_root),
                  lambda: phase_transformer_evaluate(torch, dev, splits, counts),
                  lambda: phase_transformer_train(torch, dev, train_root, counts),
                  lambda: timed("evaluate-fusion", lambda: phase_fusion(torch, counts)),
                  lambda: timed("evaluate-ensemble", lambda: phase_ensemble(torch, counts)),
                  lambda: timed("evaluate multipart --multiple_output --mrfuse",
                                lambda: phase_multihead(torch, counts)),
                  lambda: phase_search_k100(torch, dev, counts),
                  lambda: timed("evaluate zoo", lambda: phase_zoo_evaluate(torch, counts)),
                  lambda: timed("train densenet121",
                                lambda: phase_densenet_train(torch, counts, train_root)),
                  lambda: timed("evaluate --rerank", lambda: phase_rerank_evaluate(torch, counts)),
                  lambda: phase_search_rerank(torch, dev, counts),
                  lambda: walled(lambda: phase_datasets(torch, counts)))
    int8_phases = (lambda: walled(lambda: phase_evaluate_int8(torch, dev, splits, counts)),
                   lambda: phase_search_serve_int8(torch, splits, counts),
                   lambda: walled(lambda: phase_fusion_ensemble_int8(torch, counts)),
                   lambda: timed("evaluate vit --quantize int8",
                                 lambda: phase_vit_int8(torch, dev, splits, counts)),
                   lambda: timed("train --mining_quantize int8",
                                 lambda: phase_train_int8(torch, counts, train_root)))
    for phase in fp_phases:
        launched = phase()
        check(launched["conv_int8"] == 0, f"a float phase launched conv_int8: {launched}")
        for name, n in launched.items():
            launches[name] += n
    counts.reset()
    torch.cuda.empty_cache()
    t_multi = time.time()
    drill = phase_drill(torch, dev, train_root)
    gang_launched, gang = phase_gang(torch, dev, train_root, counts)
    ranked_launched, bounded = phase_bounded_ranking(torch, dev, counts)
    for launched in (gang_launched, ranked_launched):
        for name, n in launched.items():
            launches[name] += n
    walls["multi-process (phase 20)"] = time.time() - t_multi
    t_rest = time.time()
    rest_launched, remainder = phase_remainder(torch, dev, train_root, counts)
    check(rest_launched["conv_int8"] == 0, f"phase 21 launched conv_int8: {rest_launched}")
    for name, n in rest_launched.items():
        launches[name] += n
    walls["remat CLIs, export, mine_subset, losses (phase 21)"] = time.time() - t_rest
    for phase in int8_phases:
        launched = phase()
        check(launched["conv_int8"] > 0, f"an int8 phase launched no conv_int8: {launched}")
        for name, n in launched.items():
            launches[name] += n
    counts.reset()

    results = {name: {"name": name, "route": "cuda", **KERNELS[name]} for name in KERNELS}
    for name, entry in _time_k3(torch, dev, 64, 1 << 20, 1 << 20, reps=20, plain_reps=3).items():
        results[name].update(entry)
    # the serve path's shape: its 200 probes over its 512-row index of 400 images
    for name, entry in _time_k3(torch, dev, n_q, capacity, n_g, reps=200, plain_reps=20).items():
        results[name]["at_path_shape"] = entry
        log(f"timing {name} at the path's shape: {json.dumps(entry)}")
    _time_k2(torch, dev, results)
    results["rank_counts"]["at_msmt17_protocol"] = _time_k2_msmt17(torch, dev)
    results["search_topk_f32"]["max_abs_err"] = max(results["search_topk_f32"]["max_abs_err"],
                                                    f32_err)
    results["fused_augment"].update(_time_k1(torch, dev))
    results["fused_augment"]["max_abs_err"] = max(results["fused_augment"]["max_abs_err"], k1_err)
    k4_times = _time_k4(torch, dev)
    results["flash_attention"].update(k4_times[0])
    results["flash_attention"]["at_n53"] = k4_times[1]
    results["flash_attention"]["max_abs_err"] = max(k4_times[0]["max_abs_err"],
                                                    k4_times[1]["max_abs_err"], k4_err)
    results["flash_attention"]["backward_max_abs_err"] = k4_bwd_err
    for name, kernels in PATH_KERNELS.items():
        lib = Path(KERNELS[name]["source"]).stem
        results[name]["ptxas"] = {k: ptxas.get(lib, {}).get(k) for k in kernels}
    step = _time_train_step(torch, dev, train_root)
    fusion_times = _time_fusion_at_market(torch, dev)
    rates = _time_extraction(torch, dev)
    jpm = _time_jpm(torch, dev, train_root)
    zoo_rates = _time_zoo_extraction(torch, dev)
    dense_step = _time_densenet_train_step(torch, dev, train_root)
    rerank_times = _time_rerank(torch, dev)
    conv_times = _time_conv_int8(torch, dev, shapes)
    results["conv_int8"].update(conv_times[CONV_MAIN])
    results["conv_int8"]["max_abs_err"] = conv_err
    results["conv_int8"]["at_shapes"] = [
        {k: t[k] for k in ("shape", "plan", "ms", "bound_ms", "bound_by", "plain_ms",
                           "im2col_int_mm_ms", "cudnn_bf16_ms", "int8_input_ms")}
        for t in conv_times.values()]
    results["conv_int8"]["profiled_resnet50_int8"] = _profile_int8_resnet(torch, dev)
    int8_rates = _time_int8_extraction(torch, dev)
    for name, r in results.items():
        r["launches"] = launches[name]
        check(r["launches"] > 0, f"{name} was not launched on the main path")
        log(f"timing {name}: {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']} ms, "
            f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"launches on the path {r['launches']}")
    log(f"extraction img/s (bf16, 256x128): {json.dumps({str(b): v for b, v in rates.items()})}")
    log(f"train step: {step['step_ms']:.3f} ms, {step['img_per_s']:.1f} img/s "
        f"(K1 {step['augment_ms']:.4f} ms, forward+backward {step['forward_backward_ms']:.3f} ms, "
        f"Adam+EMA {step['adam_ema_ms']:.3f} ms), peak {step['peak_memory_gb']:.2f} GB, "
        f"host decode {step['host_decode_ms_per_batch']:.1f} ms a batch; with decode prefetched "
        f"{step['pipeline_ms_per_step']:.1f} ms a step, {step['pipeline_img_per_s']:.1f} img/s "
        f"over {step['pipeline_steps']} steps after the fill; profiled: device busy "
        f"{step['profiled_device_busy_ms_per_step']:.3f} ms a step "
        f"({100 * step['profiled_busy_share']:.1f}% of the wall time), BN kernels "
        f"{step['batch_norm_kernels_ms_per_step']:.3f} ms a step")
    for name, h in step["host_by_decoder"].items():
        if isinstance(h, dict):
            log(f"host decode ({name}): {h['host_decode_ms_per_batch']:.1f} ms a batch of "
                f"{step['batch']} (by threads {json.dumps(h['host_decode_ms_by_threads'])}); "
                f"the loop with decode prefetched {h['pipeline_ms_per_step']:.1f} ms a step, "
                f"{h['pipeline_img_per_s']:.1f} img/s")
    log(f"host decoder on the main path: "
        f"{'native C++ loader, ' + decoder['linked_libjpeg'] + ' libjpeg' if decoder['native_loader'] else 'PIL'}")
    log("evaluation and train CLI wall times (bf16, 256x128, seconds): " + json.dumps(walls))
    log(f"fusion at Market-1501's shape: magnitude_weighted_distmat "
        f"{fusion_times['magnitude_weighted_distmat_ms']:.4f} ms (bound "
        f"{fusion_times['magnitude_bound_ms']:.4f} ms, bytes), 7 rankings "
        f"{fusion_times['seven_rankings_ms']:.1f} ms")
    k4_forward = (12 * results["flash_attention"]["ms"]
                  + 4 * results["flash_attention"]["at_n53"]["ms"])
    for route in ("k4", "sdpa"):
        r = jpm[route]
        log(f"JPM train step ({route}): {r['step_ms']:.3f} ms, {r['img_per_s']:.1f} img/s "
            f"(K1 {r['augment_ms']:.4f} ms, forward+backward {r['forward_backward_ms']:.3f} ms, "
            f"Adam+EMA {r['adam_ema_ms']:.3f} ms), peak {r['peak_memory_gb']:.2f} GB; "
            f"extraction at 512: {r['extract_img_per_s_at_512']:.1f} img/s")
    log(f"K4 in one JPM forward of {jpm['batch']}: 12 x N=211 + 4 x N=53 = {k4_forward:.3f} ms")
    for mode in ("none", "full", "tuned"):
        r = jpm["remat"][mode]
        log(f"remat {mode}: JPM train step with K4 {r['step_ms']:.3f} ms, {r['img_per_s']:.1f} "
            f"img/s, peak {r['peak_memory_gb']:.2f} GB, K4 {r['k4_launches']} launches a step, "
            f"gradient bit-equal to none's: {r['grads_bit_equal_to_none']}")
    for name, r in remainder["export"].items():
        log(f"export {name} ({r['keys']} tensors, {r['mb']:.1f} MB): .pt -> .npz "
            f"{r['to_npz_s']:.2f} s, .npz -> .pth {r['to_torch_s']:.2f} s, bit-equal")
    k4 = results["flash_attention"]
    bwd = (k4["backward_ms"], k4["at_n53"]["backward_ms"])
    log(f"attention_backward alone (bf16, plain f32 torch): N=211 {bwd[0]:.4f} ms, N=53 "
        f"{bwd[1]:.4f} ms; one JPM step of {jpm['batch']}: 12 x N=211 + 4 x N=53 = "
        f"{12 * bwd[0] + 4 * bwd[1]:.3f} ms")
    log("zoo extraction at batch 512 (bf16, 256x128): "
        + ", ".join(f"{n} {r['img_per_s']:.1f} img/s peak {r['peak_memory_gb']:.2f} GB"
                    for n, r in zoo_rates.items()))
    log(f"densenet121 train step: {dense_step['step_ms']:.3f} ms, "
        f"{dense_step['img_per_s']:.1f} img/s, peak {dense_step['peak_memory_gb']:.2f} GB")
    log(f"re_ranking at Market-1501's shape (Q=3368, G=15913): "
        f"{rerank_times['market_ms']:.1f} ms, peak {rerank_times['market_peak_memory_gb']:.2f} GB "
        f"above its inputs; re-ranked search Q=200 over 400 rows at depth 64: "
        f"{rerank_times['search_q200_g400_depth64_ms']:.2f} ms (device re-ranking "
        f"{rerank_times['shortlists_q200_depth64_device_ms']:.3f} ms)")
    log("int8 extraction at batch 512 (256x128; bf16 in the same call): "
        + ", ".join(f"{n} int8 {r['int8_img_per_s']:.1f} img/s (bf16 {r['bf16_img_per_s']:.1f}) "
                    f"peak {r['int8_peak_memory_gb']:.2f} GB" for n, r in int8_rates.items()))
    g = gang
    bn_t = g["gang_bn"]["forward_backward"]
    log(f"multi-process (phase 20): gang bootstrap {g['bootstrap_gloo_s']:.3f} s (2 ranks, "
        f"gloo), {g['bootstrap_nccl_s']:.3f} s (1 rank, NCCL); train step (ResNet-50 bf16, "
        f"{2 * P * K} images a step): one process {g['timing_plain']['step_ms']:.1f} ms, the "
        f"1-rank NCCL gang {g['timing_nccl']['step_ms']:.1f} ms (its BN reductions and gradient "
        f"all-reduce), 2 gloo ranks of {g['timing_gloo']['rows_per_rank']} rows on the one card "
        f"{g['timing_gloo']['step_ms']:.1f} ms; gang BN forward+backward at "
        f"{g['gang_bn']['shape']}: fused {bn_t['fused_ms']:.3f} ms, eager "
        f"{bn_t['plain_ms']:.3f} ms, one process's F.batch_norm "
        f"{bn_t['single_process_ms']:.3f} ms; a {g['timing_gloo']['all_reduce_mb']:.1f} MB "
        f"all-reduce: gloo (2 ranks) {g['timing_gloo']['all_reduce_ms']:.3f} ms, NCCL not "
        f"measurable on one card; first step against one process: "
        f"{json.dumps(g['first_step_vs_one_process'])}; bounded-memory ranking at MSMT17's shape "
        f"{bounded['sharded']['ms']:.1f} ms, {bounded['sharded']['peak_gb_above_inputs']:.2f} GB "
        f"(K2 {bounded['sharded']['k2_launches']} launches) against replicated "
        f"{bounded['replicated']['ms']:.1f} ms, {bounded['replicated']['peak_gb_above_inputs']:.2f} "
        f"GB; drill stitched state bit-exact")
    log(f"card: {card}; total {time.time() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "check", "shape")
    extra = ("at_path_shape", "at_path_p", "at_max_positives_bound", "at_msmt17_protocol",
             "at_n53",
             "backward_max_abs_err",
             "backward_ms", "ptxas", "library", "plan", "im2col_int_mm_ms", "cudnn_bf16_ms",
             "int8_input_ms", "at_shapes", "profiled_resnet50_int8")
    kernels = [{k: r[k] for k in keys + extra if k in r} for r in results.values()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
