"""The port's multi-process paths: 2-process ``gloo`` gangs on the CPU.

Mirrors the six two-process tests of ``tests/test_distributed.py`` (``:70``
psum, ``:138`` extraction, ``:217`` a train epoch, ``:349`` gallery search,
``:393`` the failure drill, ``:479`` sharded ranking) with the port's
``torch.distributed`` helpers (``daliid_tpu_torch/parallel``), plus the
single-process supervisor, int8 calibration over two ranks and the
grad-accum chunks within a rank's block. Every rank is a real process,
bootstrapped through a localhost store, on ``--device cpu`` with one torch
thread and a hard timeout.

Tolerances:
- the collectives, the K1 pixels, the int8 scales, SQ8 search, ranking
  CMCs and the drill's stitched state: exact;
- mAP: 1e-12 (float64 summation order);
- embeddings against JAX's single-process extractor: 1e-4 of the largest
  entry (``test_torch_resnet.py``'s); f32 search scores: 1e-5 relative;
- a train step against a 1-rank gang (the same code on one process): the
  metrics 1e-5 relative, the gradients 1e-4 of the largest (measured 4e-6:
  the order of the sums over ranks), the BN running statistics 1e-4
  relative;
- a train step against one process without a gang (torch's fused BN): the
  metrics and BN statistics as above (the unbiased global variance; the
  biased one is off by ``n / (n - 1)``, 14% at the embedding BN's n = 8);
  the gradients 2e-2 in relative L2 norm (measured 6e-3): where the two
  BNs round an activation differently in its last bit, the stem's max pool
  can pick another element of a near-tie and route that gradient
  elsewhere, which moves some early gradients by several percent (with the
  pool averaged instead the two agree within 2e-6 of the largest);
- a train epoch (4 steps) against both: the mean loss 1e-3 relative
  (measured 2.5e-4); the parameters within Adam's reach, 2 x 3.2 lr a step
  (9e-3; measured 2e-3: Adam moves a parameter by up to about 3.2 lr a
  step whatever the size of its gradient, so rounding-level differences
  in near-zero gradients grow into lr-sized ones); the BN running
  statistics, which follow the activations those parameters move, 0.1
  absolute (measured 0.05 on running variances near 1.5); the 2 ranks
  agree with each other bit for bit.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daliid_tpu.data.native_loader as jax_native_loader
from daliid_tpu.eval.features import FeatureExtractor as JaxExtractor
from daliid_tpu.eval.matcher import GalleryIndex as JaxIndex
from daliid_tpu.models.factory import ModelBundle as JaxBundle
from daliid_tpu.models.resnet import ResNet50ReID as FlaxResNet
from daliid_tpu_torch.models.torch_port import variables_from_jax
from daliid_tpu_torch.train.trainer import microbatch_slots

REPO = Path(__file__).resolve().parents[1]
STAGES = (1, 1, 1, 1)
IMG = (32, 16)
TIMEOUT = 240

_HEAD = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
import daliid_tpu_torch.data.native_loader as native_loader
native_loader.native_loader_available = lambda: False  # PIL decode, as the JAX side
from daliid_tpu_torch.parallel import initialize_multihost
RANK = int(sys.argv[1])
INFO = initialize_multihost("127.0.0.1:" + sys.argv[2], 2, RANK, device="cpu")
OUT = sys.argv[3]
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["MKL_NUM_THREADS"] = "1"
    return env


def _gang(tmp_path, body: str, n: int = 2) -> list[str]:
    """Run ``_HEAD + body`` as ranks 0..n-1 of one gang → their outputs;
    every rank must exit 0."""
    script = tmp_path / "worker.py"
    script.write_text(_HEAD.format(repo=str(REPO)) + body)
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port, str(out)],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(n)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
    return outs


def _single_process(tmp_path, body: str, name: str = "one", gang: bool = False) -> str:
    """``body`` in one process (rank 0), with the ranks' one torch thread: no
    process group, or with ``gang`` a 1-rank gang; outputs under ``name``."""
    script = tmp_path / f"{name}.py"
    head = _HEAD.format(repo=str(REPO)).replace(
        'initialize_multihost("127.0.0.1:" + sys.argv[2], 2, RANK, device="cpu")',
        'initialize_multihost("127.0.0.1:" + sys.argv[2], 1, 0, device="cpu")' if gang
        else "None")
    script.write_text(head + body)
    (tmp_path / name).mkdir()
    r = subprocess.run([sys.executable, str(script), "0", str(_free_port()), str(tmp_path / name)],
                       env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


# ---------------------------------------------------------------- :70 psum
_COLLECTIVES = r"""
from daliid_tpu_torch.parallel import (
    active, all_reduce_, all_reduce_sum, barrier, gather_rows, local_rows, pad_to_multiple, rank,
    row_range, world)

assert INFO == {"process_index": RANK, "process_count": 2, "local_devices": 1,
                "global_devices": 2, "backend": "gloo", "device": "cpu"}, INFO
assert active() and world() == 2 and rank() == RANK
# psum of [0, 1, 2, 3] sharded one block a rank
x = local_rows(torch.arange(4.0))
assert x.tolist() == ([0.0, 1.0] if RANK == 0 else [2.0, 3.0])
assert float(all_reduce_(x.sum().clone())) == 6.0
assert all_reduce_(torch.tensor([float(RANK), 5.0 - RANK]), "max").tolist() == [1.0, 5.0]
assert row_range(7) == ((0, 4) if RANK == 0 else (4, 7)) and row_range(1) == ((0, 1), (1, 1))[RANK]
padded, n = pad_to_multiple(torch.ones(5, 3), world())
assert n == 5 and padded.shape == (6, 3) and padded[5].sum() == 0
assert pad_to_multiple(np.ones((2, 4)), 2, axis=1)[0].shape == (2, 4)
# uneven blocks gather in rank order; the backward keeps this rank's rows
local = (torch.arange(3 - RANK, dtype=torch.float64) + 10 * RANK).requires_grad_(True)
full = gather_rows(local, [3, 2])
assert full.tolist() == [0.0, 1.0, 2.0, 10.0, 11.0], full
(full * torch.arange(1.0, 6.0, dtype=torch.float64)).sum().backward()
assert local.grad.tolist() == ([1.0, 2.0, 3.0] if RANK == 0 else [4.0, 5.0]), local.grad
# a differentiable sum: each rank's input reaches every rank's output
y = torch.tensor([1.0 + RANK], requires_grad=True)
s = all_reduce_sum(y * (RANK + 1))
assert s.item() == 1.0 + 4.0
(s * (RANK + 1)).sum().backward()
assert y.grad.item() == (RANK + 1) * 3.0, y.grad
barrier()
print("collectives OK")
"""


def test_two_process_collectives(tmp_path):
    assert all("collectives OK" in o for o in _gang(tmp_path, _COLLECTIVES))


# ---------------------------------------------------------------- :138 extraction, int8 scales
_EXTRACT = r"""
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.models.factory import ModelBundle
from daliid_tpu_torch.models.resnet import ResNet50ReID

paths = json.load(open(os.path.join(OUT, "..", "paths.json")))
model = ResNet50ReID(stage_sizes=(1, 1, 1, 1)).eval()
model.load_state_dict(torch.load(os.path.join(OUT, "..", "state.pt")), strict=True)
bundle = ModelBundle(module=model, feature_dim=2048, name="tiny")
feats = FeatureExtractor(bundle, img_size=(32, 16), batch_size=4, device="cpu").extract(paths)
np.save(os.path.join(OUT, f"f32_{RANK}.npy"), feats)
ex8 = FeatureExtractor(bundle, img_size=(32, 16), batch_size=4, device="cpu",
                       quantize="int8", calib_batches=2)
np.save(os.path.join(OUT, f"int8_{RANK}.npy"), ex8.extract(paths))
json.dump(ex8.quant_scales, open(os.path.join(OUT, f"scales_{RANK}.json"), "w"))
print("extraction OK")
"""


def _flax_variables():
    module = FlaxResNet(stage_sizes=STAGES)
    variables = jax.device_get(module.init(jax.random.key(12), jnp.zeros((1, *IMG, 3)),
                                           train=False))
    rng = np.random.default_rng(3)
    ranges = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.1, 0.1), "var": (0.5, 2.0)}

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else (
            rng.uniform(*ranges[k], v.shape).astype(np.float32) if k in ranges else np.asarray(v))
            for k, v in tree.items()}

    return module, walk(variables)


def test_two_process_extraction_matches_jax_and_calibrates_like_one_process(
        tmp_path, monkeypatch):
    """Each rank decodes and forwards its block of every batch of 4 and
    gathers the rest: 5 images give the tail batch one real row, all on
    rank 0. The gathered embeddings equal JAX's single-process extractor's
    (1e-4 of the largest entry). The int8 scales, merged with a MAX
    all-reduce over the ranks (rank 1 has no real row in the tail batch,
    the second of two calibration batches), equal one process's bit for
    bit, and so do the int8 embeddings (one process with the ranks' one
    torch thread: the CPU's convolutions round differently with more)."""
    from PIL import Image

    images = np.random.default_rng(4).integers(0, 256, (5, *IMG, 3), dtype=np.uint8)
    paths = []
    for i, im in enumerate(images):
        paths.append(str(tmp_path / f"{i}.png"))  # lossless: the decode is exact
        Image.fromarray(im).save(paths[-1])
    (tmp_path / "paths.json").write_text(json.dumps(paths))
    module, variables = _flax_variables()
    state = variables_from_jax("resnet50", variables)
    torch.save(state, tmp_path / "state.pt")
    outs = _gang(tmp_path, _EXTRACT)
    assert all("extraction OK" in o for o in outs)
    out = tmp_path / "out"

    monkeypatch.setattr(jax_native_loader, "native_loader_available", lambda: False)
    jax_ex = JaxExtractor(JaxBundle(module=module, variables=variables, feature_dim=2048,
                                    name="tiny"), img_size=IMG, batch_size=8)
    want = jax_ex.extract(paths)
    for r in range(2):
        got = np.load(out / f"f32_{r}.npy")
        assert got.shape == (5, 2048)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())

    _single_process(tmp_path, _EXTRACT)
    for r in range(2):
        assert (json.loads((out / f"scales_{r}.json").read_text())
                == json.loads((tmp_path / "one" / "scales_0.json").read_text()))
        np.testing.assert_array_equal(np.load(out / f"int8_{r}.npy"),
                                      np.load(tmp_path / "one" / "int8_0.npy"))


# ---------------------------------------------------------------- :217 a train epoch
_TRAIN = r"""
import copy
from daliid_tpu_torch.data.registry import parse_market_duke_dir
from daliid_tpu_torch.models.factory import ModelBundle, init_weights
from daliid_tpu_torch.models.resnet import ResNet50ReID
from daliid_tpu_torch.train.sampler import PKBatchSampler
from daliid_tpu_torch.train.trainer import Trainer

ROOT = os.path.join(OUT, "..", "ds")


def trainer(grad_accum):
    model = ResNet50ReID(stage_sizes=(1, 1, 1, 1))
    init_weights(model, torch.Generator().manual_seed(0))
    table = parse_market_duke_dir(os.path.join(ROOT, "bounding_box_train"))
    sampler = PKBatchSampler(table, table.pids, P=2, K=2, kind_of_transform=1,
                             turbulence_dir=os.path.join(ROOT, "turbulence"), seed=0)
    return Trainer(ModelBundle(module=model, feature_dim=2048, name="tiny"),
                   ModelBundle(module=copy.deepcopy(model), feature_dim=2048, name="tiny"),
                   sampler, img_size=(32, 16), num_epochs=2, compute_dtype=torch.float32,
                   extractor_batch=8, decode_workers=1, grad_accum=grad_accum)


def first_step(tr, tag):
    pset = tr.mine_proxies()
    images_u8, labels, dist, mask, camids = tr._stage(next(iter(tr.sampler.epoch())))
    images = tr.augment(images_u8)
    m = tr.forward_backward(images, labels, dist, mask, torch.as_tensor(pset.centers),
                            torch.as_tensor(pset.proxies),
                            torch.as_tensor(pset.proxy_labels).long(), 1, camids)
    grads = torch.cat([p.grad.reshape(-1) for p in tr._params if p.grad is not None])
    np.savez(os.path.join(OUT, f"{tag}_{RANK}.npz"), images=images.numpy(), m=m.numpy(),
             grads=grads.numpy(), centers=pset.centers,
             **{"bn_" + k.replace(".", "_"): v.numpy() for k, v in tr.online.state_dict().items()
                if "running" in k})


first_step(trainer(1), "step")
first_step(trainer(2), "accum")
tr = trainer(1)
means = tr.train_epoch(1)
state = {k: v.numpy() for k, v in tr.online.state_dict().items()}
np.savez(os.path.join(OUT, f"epoch_{RANK}.npz"), loss=means["loss"],
         **{k.replace(".", "_"): v for k, v in state.items()})
print("train OK", means["loss"])
"""


def test_two_process_train_step_and_epoch_match_one_process(tmp_path):
    """A paired PK batch of 8 (P2 K2) split 4 + 4, held against a 1-rank
    gang (the same code on one process) and against one process without a
    gang (torch's fused BN): each rank's K1 pixels are one process's rows
    bit for bit; the first step's metrics, gradients and BN running
    statistics (the unbiased global variance) match, also with grad_accum 2
    (strided chunks within each rank's block, weighted by the global valid
    count); after an epoch of 4 steps both ranks hold the same state bit for
    bit, within the module note's tolerances of the others."""
    from daliid_tpu_torch.data import make_synthetic_dataset

    make_synthetic_dataset(str(tmp_path / "ds"), num_ids=8, imgs_per_id_train=3,
                           imgs_per_id_test=2, height=IMG[0], width=IMG[1])
    outs = _gang(tmp_path, _TRAIN)
    assert all("train OK" in o for o in outs)
    _single_process(tmp_path, _TRAIN, "one_gang", gang=True)
    _single_process(tmp_path, _TRAIN)
    out = tmp_path / "out"
    for tag in ("step", "accum"):
        ranks = [np.load(out / f"{tag}_{r}.npz") for r in range(2)]
        np.testing.assert_array_equal(ranks[0]["centers"], ranks[1]["centers"])
        for ref, grad_check in (("one_gang", "max"), ("one", "l2")):
            want = np.load(tmp_path / ref / f"{tag}_0.npz")
            np.testing.assert_array_equal(np.concatenate([z["images"] for z in ranks]),
                                          want["images"])
            bn = [k for k in want.files if k.startswith("bn_")]
            assert len(bn) > 10 and any(k.endswith("running_var") for k in bn)
            for z in ranks:
                np.testing.assert_allclose(z["m"], want["m"], rtol=1e-5)
                g, got = want["grads"], z["grads"]
                if grad_check == "max":
                    np.testing.assert_allclose(got, g, rtol=0, atol=1e-4 * np.abs(g).max())
                else:
                    assert np.linalg.norm(got - g) <= 2e-2 * np.linalg.norm(g), (tag, ref)
                for k in bn:
                    np.testing.assert_allclose(z[k], want[k], rtol=1e-4, atol=1e-6,
                                               err_msg=f"{ref} {k}")
    ranks = [np.load(out / f"epoch_{r}.npz") for r in range(2)]
    for k in ranks[0].files:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    for ref in ("one_gang", "one"):
        want = np.load(tmp_path / ref / "epoch_0.npz")
        for k in want.files:  # Adam's reach over 4 steps; the statistics follow
            tol = 0.1 if "running" in k else 2 * 3.2 * 3.5e-4 * 4
            np.testing.assert_allclose(ranks[0][k], want[k], rtol=0, atol=tol, err_msg=k)
        loss = float(want["loss"])
        assert np.isfinite(loss) and abs(float(ranks[0]["loss"]) - loss) <= 1e-3 * loss, ref


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("n_ranks, accum", [(2, 1), (2, 2), (4, 2), (2, 4)])
def test_grad_accum_chunks_of_the_rank_blocks_are_one_process_chunks(n_ranks, accum, paired):
    """Chunk c of every rank's block, offset by the block's first row and
    taken in rank order, is one process's chunk c of the whole batch, in its
    order: the trainer's local chunks and global labels line up."""
    batch = 48
    local = microbatch_slots(batch // n_ranks, accum, paired)
    want = microbatch_slots(batch, accum, paired)
    for c in range(accum):
        got = np.concatenate([r * (batch // n_ranks) + local[c] for r in range(n_ranks)])
        np.testing.assert_array_equal(got, want[c])


# ---------------------------------------------------------------- :349 gallery search
_SEARCH = r"""
from daliid_tpu_torch.eval.matcher import GalleryIndex

d = np.load(os.path.join(OUT, "..", "gallery.npz"))
res = {}
for mode in (None, "int8"):
    idx = GalleryIndex(d["gallery"], d["pids"], quantize=mode, device="cpu")
    assert idx._per_rank * 2 == idx._capacity and idx._gallery.shape[0] == idx._per_rank
    for k in (4, 100):
        res[f"{mode}_k{k}"] = idx.search(d["probes"], k=k)
    idx.add(d["extra"], np.asarray([100, 101, 102]))
    res[f"{mode}_add"] = idx.search(d["probes"], k=4)
    idx.remove([0, 5, 150])
    res[f"{mode}_remove"] = idx.search(d["probes"], k=70)
np.savez(os.path.join(OUT, f"search_{RANK}.npz"),
         **{f"{key}_{part}": v for key, r in res.items() for part, v in zip(("v", "i", "p"), r)})
print("search OK")
"""


def test_two_process_gallery_search_matches_jax(tmp_path):
    """The index sharded over 2 ranks (each holds its block of a per-rank
    power of two; K3 on each block, candidates all-gathered and merged by
    score then index) answers like one process's index, scores bit for bit,
    and like JAX's ``GalleryIndex``: ids and pids equal, at k = 4 (K3) and
    k = 100 and 70 (the library route), after an in-place add that lands in
    rank 1's block and after a remove that rebuilds. Against JAX, SQ8 scores
    are bit-exact on the library route, which multiplies the scales in
    JAX's order; at k <= 64 JAX's CPU route multiplies the probe's scale
    first and K3 (like JAX's Pallas kernel) last, so there they agree
    within 1e-6; f32 within 1e-5."""
    from daliid_tpu_torch.eval.matcher import GalleryIndex

    rng = np.random.default_rng(5)
    g = rng.normal(size=(203, 32)).astype(np.float32)
    pids = rng.integers(0, 20, 203)
    probes = rng.normal(size=(5, 32)).astype(np.float32)
    extra = rng.normal(size=(3, 32)).astype(np.float32)
    np.savez(tmp_path / "gallery.npz", gallery=g, pids=pids, probes=probes, extra=extra)
    assert all("search OK" in o for o in _gang(tmp_path, _SEARCH))
    ranks = [np.load(tmp_path / "out" / f"search_{r}.npz") for r in range(2)]
    for key in ranks[0].files:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)
    got = ranks[0]
    for mode in (None, "int8"):
        for index in (GalleryIndex(g, pids, quantize=mode, device="cpu"),
                      JaxIndex(g, pids, quantize=mode)):
            jax_side = isinstance(index, JaxIndex)
            want = {f"{mode}_k{k}": index.search(probes, k=k) for k in (4, 100)}
            index.add(extra, np.asarray([100, 101, 102]))
            want[f"{mode}_add"] = index.search(probes, k=4)
            index.remove([0, 5, 150])
            want[f"{mode}_remove"] = index.search(probes, k=70)
            for key, (v, i, p) in want.items():
                np.testing.assert_array_equal(got[f"{key}_i"], np.asarray(i), err_msg=key)
                np.testing.assert_array_equal(got[f"{key}_p"], np.asarray(p), err_msg=key)
                if not jax_side or (mode == "int8" and key.endswith(("k100", "remove"))):
                    np.testing.assert_array_equal(got[f"{key}_v"], np.asarray(v), err_msg=key)
                else:
                    np.testing.assert_allclose(got[f"{key}_v"], np.asarray(v), atol=1e-7,
                                               rtol=1e-6 if mode else 1e-5, err_msg=key)


# ---------------------------------------------------------------- :479 sharded ranking
_RANK = r"""
import daliid_tpu_torch.metrics.ranking as ranking
from daliid_tpu_torch.metrics.ranking import (
    cosine_distance_matrix, evaluate_rank_numpy, evaluate_rank_sharded,
    evaluate_rank_sharded_multihead, max_positives_bound, queried_positives_bound)

rng = np.random.default_rng(7)
NQ, NG, D, IDS = 37, 61, 32, 9


def make(n, ids):
    pids = rng.integers(0, IDS, n).astype(np.int32)
    cams = rng.integers(0, 4, n).astype(np.int32)
    fvs = (np.eye(IDS, D)[pids] + 0.8 * rng.normal(size=(n, D))).astype(np.float32)
    return fvs, pids, cams


q, qp, qc = make(NQ, IDS)
g, gp, gc = make(NG, IDS)
gp[:20] = 99  # a distractor pid no query asks for: max_positives_bound > the queried bound
slots = []
original = ranking.positive_rank_counts


def recording(dist, p_dist, *a, **kw):
    slots.append(p_dist.shape[1])
    return original(dist, p_dist, *a, **kw)


ranking.positive_rank_counts = recording
distmat = cosine_distance_matrix(torch.from_numpy(q), torch.from_numpy(g)).numpy()
cmc_ref, map_ref = evaluate_rank_numpy(distmat, qp, gp, qc, gc, max_rank=10)
cmc, mAP = evaluate_rank_sharded(q, g, qp, gp, qc, gc, max_rank=10, query_chunk=7)
np.testing.assert_array_equal(cmc, cmc_ref)
assert abs(mAP - map_ref) <= 1e-12, (mAP, map_ref)
# this rank's 19 (or 18) queries in chunks of 7: 3 launches, P from the queried pids
assert slots == [queried_positives_bound(qp, gp)] * 3, slots
assert slots[0] < max_positives_bound(gp), (slots, max_positives_bound(gp))
heads_q, heads_g = [q, 2.0 * q[:, :16]], [g, 3.0 * g[:, :16]]
for weighting in ("mean", "magnitude"):
    d_heads = [cosine_distance_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
               for a, b in zip(heads_q, heads_g)]
    if weighting == "mean":
        merged = np.mean(d_heads, axis=0)
    else:
        w = [np.maximum(np.linalg.norm(a, axis=1)[:, None], np.linalg.norm(b, axis=1)[None])
             for a, b in zip(heads_q, heads_g)]
        merged = sum(x * y for x, y in zip(w, d_heads)) / sum(w)
    want = evaluate_rank_numpy(merged, qp, gp, qc, gc, max_rank=10)
    got = evaluate_rank_sharded_multihead(heads_q, heads_g, qp, gp, qc, gc, max_rank=10,
                                          query_chunk=8, head_weighting=weighting)
    np.testing.assert_array_equal(got[0], want[0])
    assert abs(got[1] - want[1]) <= 1e-12, (weighting, got[1], want[1])
empty = evaluate_rank_sharded(q[:0], g, qp[:0], gp, qc[:0], gc, max_rank=10)
assert empty[0].shape == (10,) and not empty[0].any() and empty[1] == 0.0
print("sharded ranking OK", mAP)
"""


def test_two_process_sharded_ranking(tmp_path):
    """Each rank ranks its block of 37 queries against the whole gallery,
    7 rows a chunk through K2's plain version, and the sums merge with one
    all-reduce: CMC equal to ``evaluate_rank_numpy`` on the full distmat,
    mAP within 1e-12, for one embedding and for the multi-head merges (mean
    and magnitude); an empty query set gives a (max_rank,) CMC; K2's P is
    ``queried_positives_bound`` over the whole query set, below
    ``max_positives_bound`` when an unqueried distractor pid is frequent."""
    outs = _gang(tmp_path, _RANK)
    maps = [o.split("sharded ranking OK")[1].split()[0] for o in outs]
    assert maps[0] == maps[1], maps


# ---------------------------------------------------------------- :393 the failure drill
def _supervise(tmp_path, name, multihost, epochs, *extra):
    root = tmp_path / "data"
    if not root.exists():
        from daliid_tpu_torch.data import make_synthetic_dataset

        make_synthetic_dataset(str(root / "Synthetic"), num_ids=4, imgs_per_id_train=2,
                               imgs_per_id_test=2, height=IMG[0], width=IMG[1])
    argv = [sys.executable, "-m", "daliid_tpu_torch", "supervise", "--multihost",
            str(multihost), "--max_restarts", "2", "--backoff_seconds", "0",
            "--teardown_grace_seconds", "5", "--",
            "--device", "cpu", "--dataset", "Synthetic", "--data_root", str(root),
            "--model_name", "osnet", "--img_height", str(IMG[0]), "--img_width", str(IMG[1]),
            "--P", "2", "--K", "2", "--epochs", str(epochs), "--eval_freq", "100",
            "--ckpt_freq", "1", "--compute_dtype", "float32", "--extractor_batch", "8",
            "--skip_initial_eval", "--path_to_save_models", str(tmp_path / name),
            "--path_to_save_metrics", str(tmp_path / f"{name}_metrics"), *extra]
    r = subprocess.run(argv, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout[-4000:]
    return r.stdout


def _assert_trees_equal(a, b, where="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{where}[{i}]")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_multihost_failure_drill_is_bit_exact(tmp_path):
    """A 2-rank gang (OSNet, BatchNorm throughout) trains 3 epochs under
    ``supervise --multihost 2``; in the second run rank 1 is SIGKILLed after
    epoch 2, before its save. Rank 0 blocks at the save's barrier and dies
    without committing epoch 2; the supervisor tears the gang down and
    relaunches both ranks with --resume from epoch 1. The stitched run's
    final checkpoint equals the uninterrupted gang's bit for bit: both
    models' parameters and BN statistics, Adam's moments and steps, and the
    RNG streams."""
    clean = _supervise(tmp_path, "clean", 2, 3)
    assert "training completed after 1 attempt(s)" in clean, clean[-3000:]
    fault = _supervise(tmp_path, "fault", 2, 3, "--fault_inject_epoch", "2",
                       "--fault_inject_rank", "1")
    for line in ("fault injection: SIGKILL rank 1 after epoch 2", "rank 1 exited rc=-9",
                 "[supervise] attempt 2", "Resumed from epoch 1",
                 "training completed after 2 attempt(s)"):
        assert line in fault, (line, fault[-4000:])
    assert "'backend': 'gloo'" in fault
    a = torch.load(tmp_path / "clean" / "latest" / "3.pt", weights_only=True)
    b = torch.load(tmp_path / "fault" / "latest" / "3.pt", weights_only=True)
    assert a["epoch"] == b["epoch"] == 3
    assert len(a["state"]["optimizer"]["state"]) > 100  # Adam's moments of every tensor
    _assert_trees_equal(a["state"], b["state"])
    _assert_trees_equal(a["rng"], b["rng"], "rng")


def test_supervise_restarts_one_plain_process(tmp_path):
    """``supervise --multihost 0``: every rank (the one process) raises
    after epoch 2; the supervisor restarts it with --resume from epoch 1."""
    out = _supervise(tmp_path, "single", 0, 2, "--fault_inject_epoch", "2")
    for line in ("fault injection: simulated crash after epoch 2", "trainer exited rc=1",
                 "[supervise] attempt 2", "Resumed from epoch 1",
                 "training completed after 2 attempt(s)"):
        assert line in out, (line, out[-4000:])
    assert "multihost:" not in out
    assert (tmp_path / "single" / "latest" / "2.pt").exists()
