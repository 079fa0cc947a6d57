#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``daliid_tpu_torch``) on one GPU.

Phases, in order; any failed check exits non-zero and prints no result:

1. device: ``nvidia-smi`` name and power limit, the torch device name;
   build every ``daliid_tpu_torch/csrc/*.cu`` with nvcc (one process per
   source, in parallel); generate the synthetic set (100 identities).
2. K2 ``rank_counts`` against its plain version on the card: random and
   tie-fuzzed distances, ragged shapes, the evaluate path's shape,
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
   and (2, 37, 19), pad 10 and 4, crop offsets at 0 and 2*pad, erase
   rectangles touching each border; f32 within 2e-5, bf16 within one bf16
   ulp (or 2e-5 where that ulp is finer).
8. train: ``cli.train.main`` in-process: ResNet-50 at 256x128, bf16,
   ``--kind_of_transform 1``, P16 K12 (384 images a step), 2 epochs with
   ``--eval_freq 1`` on a synthetic set of 32 identities x 12 train images
   with turbulence copies (4 gallery, 2 query each). The K1 counter must
   equal the number of steps (4), the K2 counter must rise (validation), the
   epoch losses must be finite and the checkpoints written.
9. timings with CUDA events after warm-up: K3 SQ8 and f32 at Q=64, D=2048,
   k=10 over 2^20 gallery rows, and at the serve path's shape; K2 at the
   Market-1501 protocol shape (Q=3368, G=15913) at P=48 and, kernel only,
   P=2800; K1 at the train shape; one train step split into augment,
   forward+backward and Adam+EMA, with img/s, peak device memory, the host
   decode time of one batch (with 1, 4 and the trainer's default number of
   threads), the train loop's steady rate with decode on its prefetch thread
   (``PIPELINE_BATCHES`` steps, timed after the first batch has arrived)
   and a ``torch.profiler`` view of three steps
   (the device's busy time, its share of the wall time, the largest
   kernels); ResNet-50 extraction img/s at batch 64 and 512 in bf16.

Then one JSON line ``{"kernels": [...]}`` and, last, the device line
``{"ok": true, "device": {...}}``. Counts of launches are set to 0 just
before each of the serve, search, evaluate and train phases and read just
after.

Run from the repository root: ``python3 chip_smoke.py``. The kernels,
the synthetic sets, the saved index and the checkpoints go under ``build/``.
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
PEAK_OPS = {"int8": 1979e12, "f32": 67e12}


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
    for name in sorted(libs):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return card, dev


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
def _k2_inputs(torch, gen, dev, n_q, n_g, n_p, ties, n_ids=7, n_cams=3):
    """Random problem with P positive slots per query: distinct gallery
    columns, some slots invalid (+inf / int32 max)."""
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
    keep = torch.rand((n_q, n_take), generator=gen, device=dev) < 0.8
    p_idx[:, :n_take] = torch.where(keep, cols, 2 ** 31 - 1).int()
    p_dist[:, :n_take] = torch.where(keep, torch.gather(dist, 1, cols), float("inf"))
    return dist, p_dist, p_idx, q_pids, q_cams, g_pids, g_cams


def phase_k2(torch, dev, path_shape):
    from daliid_tpu_torch.ops.rank_counts import positive_rank_counts, rank_counts_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cases = [
        (1, 1, 1, False), (37, 211, 9, False), (13, 57, 16, True), (129, 1537, 33, True),
        (300, 5000, 24, False), (17, 513, 64, True), (1000, 3000, 7, True),
        (*path_shape, False), (*path_shape, True),
    ]
    for n_q, n_g, n_p, ties in cases:
        args = _k2_inputs(torch, gen, dev, n_q, n_g, n_p, ties)
        for ignore in (False, True):
            got = positive_rank_counts(*args, ignore_camera=ignore)
            want = rank_counts_plain(*args, ignore_camera=ignore)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"K2 counts differ at Q={n_q} G={n_g} P={n_p} ties={ties} ignore_camera={ignore}")
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
    import numpy as np

    from daliid_tpu_torch.cli import evaluate
    from daliid_tpu_torch.eval import validate
    from daliid_tpu_torch.metrics.ranking import evaluate_rank_numpy

    seen = {}
    ranked = validate.evaluate_rank

    def recording_rank(distmat, q_pids, g_pids, q_camids, g_camids, **kw):
        seen.update(distmat=distmat.cpu().numpy(), ids=(q_pids, g_pids, q_camids, g_camids),
                    max_rank=kw["max_rank"])
        return ranked(distmat, q_pids, g_pids, q_camids, g_camids, **kw)

    args = evaluate.build_argparser().parse_args(
        ["--targets", "Synthetic", "--data_root", str(WORK / "data"), "--model_name", "resnet50",
         "--compute_dtype", COMPUTE_DTYPE, *_img_flags()])
    validate.evaluate_rank = recording_rank
    counts.reset()
    try:
        cmc, mAP = evaluate.main(args)["Synthetic"]
    finally:
        validate.evaluate_rank = ranked
    launched = counts.read()
    check(launched["rank_counts"] > 0, "the evaluate path did not launch K2")
    cmc_n, map_n = evaluate_rank_numpy(seen["distmat"], *seen["ids"], max_rank=seen["max_rank"])
    check(np.isfinite(seen["distmat"]).all(), "distance matrix is not finite")
    check(np.array_equal(cmc, cmc_n), f"CMC {cmc[:5]} != numpy oracle {cmc_n[:5]}")
    check(abs(mAP - map_n) <= 1e-12, f"mAP {mAP!r} != numpy oracle {map_n!r}")
    log(f"evaluate: R1 {cmc[0]:.4f} mAP {mAP:.6f} (oracle R1 {cmc_n[0]:.4f} mAP {map_n:.6f}, "
        f"|mAP diff| {abs(mAP - map_n):.3g}), distmat {seen['distmat'].shape}, "
        f"launches {launched}")
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
                           ((2, 37, 19), 10), ((2, 37, 19), 4), ((5, 256, 128), 10)]:
        images = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8).to(dev)
        drawn = draw_scalars(b, h, w, pad, 0.4, 0.3, 0.4, (0.05, 0.30), (0.3, 3.3), gen)
        for edge in (False, True):
            scal = (k1_edge_scalars(torch, drawn, h, w, pad) if edge else drawn).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                what = f"B={b} H={h} W={w} pad={pad} edge={edge} {dtype}"
                worst[dtype] = max(worst[dtype], k1_compare(
                    torch, fused_augment(images, scal, pad, dtype),
                    fused_augment_plain(images, scal, pad, dtype), dtype, what))
                n_cases += 1
    log(f"K1 fused_augment == plain on {n_cases} cases (max |diff| f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}), the train path's "
        f"(384, 256, 128, 3) among them")
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


# ---------------------------------------------------------------- phase 9
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
    timings["search_topk_f32"] = _timing(shape, ms, plain_ms, lib_ms, bytes_, ops, "f32", err)
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


def market_like(torch, dev, seed: int = 5):
    """Market-1501's test protocol shape with a pid table like its own:
    750 query identities, 13,115 gallery rows of those identities, 2,798
    distractor rows of pid 0 (kept, as ``parse_market_duke_dir`` keeps
    them), 6 cameras, 3,368 queries; uniform random distances."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g_pids = np.concatenate([rng.integers(1, 751, 13115), np.zeros(2798, np.int64)])
    rng.shuffle(g_pids)
    g_cams = rng.integers(1, 7, g_pids.size)
    q_pids = rng.integers(1, 751, 3368)
    q_cams = rng.integers(1, 7, q_pids.size)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dist = torch.rand((q_pids.size, g_pids.size), generator=gen, device=dev)
    return dist, q_pids, g_pids, q_cams, g_cams


def _time_k2(torch, dev, results):
    from daliid_tpu_torch.metrics.ranking import (
        _positive_prologue,
        max_positives_bound,
        positive_columns,
    )
    from daliid_tpu_torch.ops.rank_counts import positive_rank_counts, rank_counts_plain

    dist, q_pids, g_pids, q_cams, g_cams = market_like(torch, dev)
    n_q, n_g = dist.shape
    ids = [torch.as_tensor(a, dtype=torch.int32, device=dev) for a in (q_pids, q_cams, g_pids, g_cams)]
    bound_p = max_positives_bound(g_pids)
    log(f"K2 Market-like table: max_positives_bound = {bound_p} (distractor pid 0 kept)")
    for n_p, with_plain in ((48, True), (bound_p, False)):
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
        if n_p == 48:
            results["rank_counts"].update(entry)
        else:
            entry["plain"] = "skipped at this P"
            results["rank_counts"]["at_max_positives_bound"] = entry
        log(f"K2 at P={n_p}: {json.dumps(entry)}")
    del dist


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
    device memory; the host decode time of one batch."""
    from daliid_tpu_torch.data import load_dataset
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
    trainer._decode_batch(batch.paths)  # warm the decode path
    decode_ms = {}
    default_workers = trainer.decode_workers
    for workers in sorted({1, 4, default_workers}):
        trainer.decode_workers = workers
        t0 = time.time()
        for _ in range(2):
            trainer._decode_batch(batch.paths)
        decode_ms[workers] = (time.time() - t0) / 2 * 1e3
    trainer.decode_workers = default_workers
    rest = (centers, proxies, proxy_labels, 1)
    # the train loop as it runs: decode on the prefetch thread, steps on the
    # card; timed from the second batch's arrival, after the pipeline's fill
    batches = [b for _ in range(PIPELINE_BATCHES // 2) for b in sampler.epoch()]
    arrivals = []
    for staged in trainer.staged_batches(batches):
        arrivals.append(time.time())
        trainer.train_step(*staged, *rest)
    torch.cuda.synchronize(dev)
    pipeline_ms = (time.time() - arrivals[1]) / (len(batches) - 1) * 1e3
    images_u8, labels, distortions, mask = (t.to(dev) for t in trainer._stage(batch))
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
             "peak_memory_gb": peak / 1e9,
             "host_decode_ms_per_batch": decode_ms[default_workers],
             "host_decode_ms_by_threads": decode_ms, "host_cpus": os.cpu_count(),
             "pipeline_steps": len(batches) - 1, "pipeline_ms_per_step": pipeline_ms,
             "pipeline_img_per_s": b / pipeline_ms * 1e3,
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


# ---------------------------------------------------------------- counts
class Counts:
    """The launch counters of every kernel wrapper on the main path."""

    def __init__(self):
        from daliid_tpu_torch.ops.fused_augment import fused_augment
        from daliid_tpu_torch.ops.rank_counts import positive_rank_counts
        from daliid_tpu_torch.ops.search_topk import f32_search_topk, sq8_search_topk

        self.wrappers = {"rank_counts": positive_rank_counts,
                         "search_topk_sq8": sq8_search_topk,
                         "search_topk_f32": f32_search_topk,
                         "fused_augment": fused_augment}

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
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this script needs one GPU", flush=True)
        return 2
    if not (REPO / "daliid_tpu_torch" / "__init__.py").exists():
        print("[chip_smoke] daliid_tpu_torch not found beside chip_smoke.py", flush=True)
        return 2
    sys.path.insert(0, str(REPO))
    t_start = time.time()
    card, dev = phase_device(torch)
    splits = make_dataset()
    n_g, n_q = len(splits["gallery"]), len(splits["query"])
    capacity = 1 << (n_g - 1).bit_length()
    from daliid_tpu_torch.metrics.ranking import max_positives_bound

    phase_k2(torch, dev, (n_q, n_g, max_positives_bound(splits["gallery"].pids)))
    f32_err = phase_k3(torch, dev, (n_q, capacity, 2048, n_g))
    k1_err = phase_k1(torch, dev)
    train_root = make_train_dataset()

    counts = Counts()
    launches = {name: 0 for name in KERNELS}
    for phase in (lambda: phase_serve(torch, splits, counts)[0],
                  lambda: phase_search(torch, counts),
                  lambda: phase_evaluate(torch, counts),
                  lambda: phase_train(torch, counts, train_root)):
        for name, n in phase().items():
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
    results["search_topk_f32"]["max_abs_err"] = max(results["search_topk_f32"]["max_abs_err"],
                                                    f32_err)
    results["fused_augment"].update(_time_k1(torch, dev))
    results["fused_augment"]["max_abs_err"] = max(results["fused_augment"]["max_abs_err"], k1_err)
    step = _time_train_step(torch, dev, train_root)
    rates = _time_extraction(torch, dev)
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
    log(f"card: {card}; total {time.time() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "check", "shape")
    kernels = [{k: r[k] for k in keys + ("at_path_shape", "at_max_positives_bound") if k in r}
               for r in results.values()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
