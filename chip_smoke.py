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
7. timings with CUDA events after warm-up: K3 SQ8 and f32 at Q=64, D=2048,
   k=10 over 2^20 gallery rows, and at the serve path's shape; K2 at the Market-1501 protocol shape
   (Q=3368, G=15913) at P=48 and, kernel only, P=2800; ResNet-50 extraction
   img/s at batch 64 and 512 in bf16.

Then one JSON line ``{"kernels": [...]}`` and, last, the device line
``{"ok": true, "device": {...}}``. Counts of launches are set to 0 just
before each of the serve, search and evaluate phases and read just after.

Run from the repository root: ``python3 chip_smoke.py``. The kernels,
the synthetic set and the saved index go under ``build/``.
"""

from __future__ import annotations

import json
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
        from daliid_tpu_torch.ops.rank_counts import positive_rank_counts
        from daliid_tpu_torch.ops.search_topk import f32_search_topk, sq8_search_topk

        self.wrappers = {"rank_counts": positive_rank_counts,
                         "search_topk_sq8": sq8_search_topk,
                         "search_topk_f32": f32_search_topk}

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

    counts = Counts()
    launches = {name: 0 for name in KERNELS}
    for phase in (lambda: phase_serve(torch, splits, counts)[0],
                  lambda: phase_search(torch, counts),
                  lambda: phase_evaluate(torch, counts)):
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
    rates = _time_extraction(torch, dev)
    for name, r in results.items():
        r["launches"] = launches[name]
        check(r["launches"] > 0, f"{name} was not launched on the main path")
        log(f"timing {name}: {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']} ms, "
            f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"launches on the path {r['launches']}")
    log(f"extraction img/s (bf16, 256x128): {json.dumps({str(b): v for b, v in rates.items()})}")
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
