"""The port's serving and evaluation slice end to end against the JAX package (CPU).

One synthetic dataset and one weight set serve both packages: a flax
``ResNet50ReID(stage_sizes=(1, 1, 1, 1))`` initialized with
``jax.random.key(12)``, saved by the JAX package's ``save_variables`` and
loaded by the port from that ``.npz``. ``resnet50`` is rebound to these
stage sizes in both packages' model registries for the duration of the
module.

- The serve daemons of both packages run over real sockets on port 0 with
  ``--index_quantize int8``. Requests with the same pre-computed
  ``embeddings`` quantize with the same numpy code and give exact int32
  products; the JAX CPU route multiplies the two scales in the other order
  (``acc * q_scale * g_scale`` against the kernel's ``(acc * g_scale) *
  q_scale``), and the protocol rounds similarities to 6 decimals, so values
  agree within rtol 1e-6 plus atol 1e-6, and indices and pids are equal.
- Requests with image ``paths`` go through both forwards, with the JAX
  package's native JPEG loader switched off so that both decode with PIL.
  The port's native loader is switched off as well. The embeddings then
  differ within float32 summation order, which int8
  rounding can follow: top-1 pids are equal and values agree within 1e-3.
- ``cli.evaluate.main`` of both packages on ``--targets Synthetic`` in
  float32 gives R1 and mAP within one query's weight (1/len(query)).
  Measured on the CPU: R1 1.0 in both, mAP 0.9741319444 against the JAX
  package's 0.9741319418 (it accumulates AP in float32), a difference of
  3e-9 where the bound is 1/32.
"""

import json
import os
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daliid_tpu.data.native_loader as jax_native_loader
import daliid_tpu.models.factory as jax_factory
import daliid_tpu_torch.data.native_loader as port_native_loader
import daliid_tpu_torch.models.factory as port_factory
from daliid_tpu.cli import evaluate as jax_evaluate
from daliid_tpu.cli import serve as jax_serve
from daliid_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from daliid_tpu.eval.features import FeatureExtractor as JaxExtractor
from daliid_tpu.models.resnet import ResNet50ReID as FlaxResNet
from daliid_tpu.train.checkpoint import save_variables
from daliid_tpu_torch.cli import evaluate as port_evaluate
from daliid_tpu_torch.cli import serve as port_serve
from daliid_tpu_torch.data import load_dataset, make_synthetic_dataset
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.models.resnet import ResNet50ReID
from daliid_tpu_torch.ops.search_topk import sq8_search_topk

STAGES = (1, 1, 1, 1)
IMG = (64, 32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_factory.MODEL_REGISTRY, "resnet50",
                   lambda dtype=jnp.float32, **kw: (FlaxResNet(stage_sizes=STAGES, dtype=dtype), 2048))
        mp.setitem(port_factory.MODEL_REGISTRY, "resnet50",
                   lambda dtype, **kw: (ResNet50ReID(stage_sizes=STAGES, dtype=dtype), 2048))
        # both packages decode with PIL
        mp.setattr(jax_native_loader, "native_loader_available", lambda: False)
        mp.setattr(port_native_loader, "native_loader_available", lambda: False)
        bundle = jax_factory.get_model("resnet50", jax.random.key(12), img_size=IMG)
        weights = str(root / "weights.npz")
        save_variables(weights, bundle.variables)
        splits = load_dataset("Synthetic", root=str(root))
        yield {
            "root": str(root), "weights": weights, "splits": splits,
            "jax_extractor": JaxExtractor(bundle, img_size=IMG, batch_size=16),
            "port_extractor": FeatureExtractor(
                port_evaluate.load_bundle("resnet50", weights, IMG, torch.float32, "cpu"),
                img_size=IMG, batch_size=16, device="cpu"),
        }


class _Client:
    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=120)
        self.rfile = self.sock.makefile("r")

    def request(self, obj) -> dict:
        self.sock.sendall((json.dumps(obj) + "\n").encode())
        return json.loads(self.rfile.readline())

    def close(self):
        self.rfile.close()
        self.sock.close()


def _start(module, argv, extractor):
    server = module.make_server(module.build_argparser().parse_args(argv), extractor)
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05},
                              daemon=True)
    thread.start()
    return server, thread, _Client(server.server_address[1])


def _stop(server, thread, client):
    assert client.request({"op": "shutdown"})["ok"]
    client.close()
    thread.join(timeout=30)
    assert not thread.is_alive()
    server.server_close()


def _pair(world, tmp_path):
    port = _start(port_serve, ["--port", "0", "--index_quantize", "int8", "--device", "cpu",
                               "--data_dir", str(tmp_path)], world["port_extractor"])
    jax_side = _start(jax_serve, ["--port", "0", "--index_quantize", "int8",
                                  "--data_dir", str(tmp_path)], world["jax_extractor"])
    return port, jax_side


def _both(clients, req):
    rp, rj = (c.request(req) for c in clients)
    assert rp["ok"] and rj["ok"], (rp, rj)
    return rp, rj


def _same_search(rp, rj):
    np.testing.assert_allclose(rp["sims"], rj["sims"], rtol=1e-6, atol=1e-6)
    assert rp["indices"] == rj["indices"]
    assert rp["pids"] == rj["pids"]


def test_synthetic_generator_writes_the_jax_files(tmp_path):
    make_synthetic_dataset(str(tmp_path / "port"), num_ids=2, imgs_per_id_train=1,
                           imgs_per_id_test=2, turbulence_splits=("train", "gallery"))
    jax_make_synthetic(str(tmp_path / "jax"), num_ids=2, imgs_per_id_train=1,
                       imgs_per_id_test=2, turbulence_splits=("train", "gallery"))
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 2 * (1 + 2 + 1) + 2 * 3 * 5
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def test_serve_embeddings_match_jax(world, tmp_path):
    """Enroll, search, remove, save, load and stats with pre-computed
    embeddings over both daemons' sockets."""
    (ps, pt, pc), (js, jt, jc) = _pair(world, tmp_path)
    try:
        rng = np.random.default_rng(21)
        centers = rng.normal(size=(12, 2048)).astype(np.float32)
        gallery = np.repeat(centers, 3, axis=0) + 0.3 * rng.normal(size=(36, 2048)).astype(np.float32)
        pids = np.repeat(np.arange(12), 3).tolist()
        probes = (centers + 0.3 * rng.normal(size=(12, 2048)).astype(np.float32)).tolist()
        clients = (pc, jc)

        rp, rj = _both(clients, {"op": "enroll", "embeddings": gallery[:30].tolist(),
                                 "pids": pids[:30]})
        assert rp == rj
        _both(clients, {"op": "enroll", "embeddings": gallery[30:].tolist(), "pids": pids[30:]})
        rp, rj = _both(clients, {"op": "search", "embeddings": probes, "topk": 7})
        _same_search(rp, rj)
        assert np.mean(np.asarray(rp["pids"])[:, 0] == np.arange(12)) == 1.0

        rp, rj = _both(clients, {"op": "remove", "pids": [0, 5]})
        assert rp == rj and rp["num_gallery"] == 30
        _same_search(*_both(clients, {"op": "search", "embeddings": probes, "topk": 5}))

        # each daemon saves; each loads the other's file
        assert pc.request({"op": "save", "path": "port.npz"})["ok"]
        assert jc.request({"op": "save", "path": "jax.npz"})["ok"]
        assert pc.request({"op": "load", "path": "jax.npz"})["num_gallery"] == 30
        assert jc.request({"op": "load", "path": "port.npz"})["num_gallery"] == 30
        _same_search(*_both(clients, {"op": "search", "embeddings": probes[:4], "topk": 64}))
        for c in clients:
            r = c.request({"op": "save", "path": "../escape.npz"})
            assert not r["ok"] and "escapes" in r["error"]

        rp, rj = _both(clients, {"op": "stats"})
        for key in ("num_gallery", "index_quantize", "model", "requests", "errors",
                    "search_requests", "search_dispatches"):
            assert rp[key] == rj[key], key
        assert rp["index_quantize"] == "int8" and rp["busy_ms"] > 0
        # k-reciprocal re-ranking of a shortlist of every row, f32 from the
        # exact host copy on both sides
        _same_search(*_both(clients, {"op": "search", "embeddings": probes[:3], "topk": 5,
                                      "rerank": True}))
    finally:
        _stop(ps, pt, pc)
        _stop(js, jt, jc)


def test_serve_paths_match_jax(world, tmp_path):
    """Enroll the gallery split and search the query split by image path."""
    (ps, pt, pc), (js, jt, jc) = _pair(world, tmp_path)
    try:
        gallery, query = world["splits"]["gallery"], world["splits"]["query"]
        clients = (pc, jc)
        rp, rj = _both(clients, {"op": "enroll", "paths": [str(p) for p in gallery.paths],
                                 "pids": gallery.pids.tolist()})
        assert rp == rj and rp["num_gallery"] == len(gallery)
        rp, rj = _both(clients, {"op": "search", "paths": [str(p) for p in query.paths],
                                 "topk": 5})
        top1_p, top1_j = np.asarray(rp["pids"])[:, 0], np.asarray(rj["pids"])[:, 0]
        np.testing.assert_array_equal(top1_p, top1_j)
        np.testing.assert_allclose(rp["sims"], rj["sims"], atol=1e-3, rtol=0)
        rp, rj = _both(clients, {"op": "remove", "pids": [int(gallery.pids[0])]})
        assert rp == rj
    finally:
        _stop(ps, pt, pc)
        _stop(js, jt, jc)


def test_serve_concurrent_clients_micro_batch(world):
    """Searches that arrive while the device is busy share one dispatch, and
    each answer equals the same search made alone."""
    server, thread, first = _start(port_serve, ["--port", "0", "--index_quantize", "int8",
                                                "--device", "cpu"], None)
    try:
        rng = np.random.default_rng(8)
        g = rng.normal(size=(40, 96)).astype(np.float32)
        assert first.request({"op": "enroll", "embeddings": g.tolist(),
                              "pids": list(range(40))})["ok"]
        alone = [first.request({"op": "search", "embeddings": [g[i].tolist()], "topk": i % 4 + 1})
                 for i in range(8)]
        index = server.service.index
        launches = sq8_search_topk.launches
        orig = index.search

        def slow_search(*a, **kw):
            time.sleep(0.15)  # hold the device so that a queue forms
            return orig(*a, **kw)

        index.search = slow_search
        before = first.request({"op": "stats"})
        clients = [_Client(server.server_address[1]) for _ in range(8)]
        results = [None] * 8

        def ask(i):
            results[i] = clients[i].request(
                {"op": "search", "embeddings": [g[i].tolist()], "topk": i % 4 + 1})

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
        threads[0].start()
        time.sleep(0.05)
        for t in threads[1:]:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert results == alone
        after = first.request({"op": "stats"})
        assert after["search_requests"] - before["search_requests"] == 8
        assert after["search_dispatches"] - before["search_dispatches"] <= 4
        assert sq8_search_topk.launches == launches  # CPU tensors take the plain version
        for c in clients:
            c.close()
    finally:
        _stop(server, thread, first)


@pytest.mark.parametrize("quantize", ["int8", "off"])
def test_serve_batch_mixing_topk_100_and_5_answers_both(quantize):
    """One dispatch serves a topk-100 request (past K3's cap) beside a
    topk-5 one: both answered, each with the rows and pids of its own
    search made alone. That dispatch scores the topk-5 probe on the library
    route, whose SQ8 scales multiply in the other order than K3's, so
    similarities agree within the protocol's 6 decimals (atol 1e-6)."""
    server, thread, client = _start(port_serve, ["--port", "0", "--index_quantize", quantize,
                                                 "--device", "cpu"], None)
    try:
        rng = np.random.default_rng(13)
        g = rng.normal(size=(150, 64)).astype(np.float32)
        assert client.request({"op": "enroll", "embeddings": g.tolist(),
                               "pids": list(range(150))})["ok"]
        reqs = [{"op": "search", "embeddings": [g[3].tolist(), g[9].tolist()], "topk": 100},
                {"op": "search", "embeddings": [g[40].tolist()], "topk": 5}]
        alone = [client.request(r) for r in reqs]
        assert [len(a["indices"][0]) for a in alone] == [100, 5]
        service = server.service
        before = service._counters["search_dispatches"]
        entries = [{"req": r, "event": threading.Event(), "result": None} for r in reqs]
        with service._lock:
            service._serve_search_batch(entries)
        assert service._counters["search_dispatches"] == before + 1
        assert all(e["event"].is_set() for e in entries)
        for e, a in zip(entries, alone):
            r = e["result"]
            assert r["ok"] and r["indices"] == a["indices"] and r["pids"] == a["pids"]
            np.testing.assert_allclose(r["sims"], a["sims"], rtol=0, atol=1e-6)
        assert alone[0]["indices"][0][0] == 3 and alone[1]["pids"][0][0] == 40
    finally:
        _stop(server, thread, client)


@pytest.mark.parametrize("quantize", ["int8", "off"])
def test_serve_batch_mixing_reranked_and_plain_requests(quantize):
    """One batch of re-ranked requests at depth 64 and at depth 32 and two
    plain requests of different topk: three dispatches (one per re-rank
    depth, one for the plain pair at their larger k), and every answer
    equal to the same request sent alone."""
    server, thread, client = _start(port_serve, ["--port", "0", "--index_quantize", quantize,
                                                 "--device", "cpu"], None)
    try:
        rng = np.random.default_rng(17)
        centers = rng.normal(size=(30, 64)).astype(np.float32)
        g = np.repeat(centers, 5, axis=0) + 0.5 * rng.normal(size=(150, 64)).astype(np.float32)
        assert client.request({"op": "enroll", "embeddings": g.tolist(),
                               "pids": np.repeat(np.arange(30), 5).tolist()})["ok"]
        probe = lambda i: (centers[i] + 0.5 * rng.normal(size=64)).tolist()
        reqs = [{"op": "search", "embeddings": [probe(0), probe(1)], "topk": 10,
                 "rerank": True, "rerank_depth": 64},
                {"op": "search", "embeddings": [probe(2)], "topk": 10, "rerank": True,
                 "rerank_depth": 32},
                {"op": "search", "embeddings": [probe(3)], "topk": 7},
                {"op": "search", "embeddings": [probe(4)], "topk": 3}]
        alone = [client.request(r) for r in reqs]
        assert all(a["ok"] for a in alone)
        service = server.service
        before = service._counters["search_dispatches"]
        entries = [{"req": r, "event": threading.Event(), "result": None} for r in reqs]
        with service._lock:
            service._serve_search_batch(entries)
        assert service._counters["search_dispatches"] == before + 3
        for e, a in zip(entries, alone):
            r = e["result"]
            assert r["ok"] and r["indices"] == a["indices"] and r["pids"] == a["pids"]
            assert r["sims"] == a["sims"]
        # re-ranking moved the order against the plain search of the same probe
        plain = client.request({**reqs[0], "rerank": False})
        assert plain["indices"] != alone[0]["indices"]
        assert [len(a["indices"][0]) for a in alone] == [10, 10, 7, 3]
    finally:
        _stop(server, thread, client)


def test_evaluate_cli_matches_jax(world, capsys):
    common = ["--targets", "Synthetic", "--data_root", world["root"], "--model_name", "resnet50",
              "--model_path", world["weights"], "--img_height", str(IMG[0]),
              "--img_width", str(IMG[1]), "--batch_size", "16", "--compute_dtype", "float32"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_factory.MODEL_REGISTRY, "resnet50",
                   lambda dtype=jnp.float32, **kw: (FlaxResNet(stage_sizes=STAGES, dtype=dtype), 2048))
        mp.setitem(port_factory.MODEL_REGISTRY, "resnet50",
                   lambda dtype, **kw: (ResNet50ReID(stage_sizes=STAGES, dtype=dtype), 2048))
        mp.setattr(jax_native_loader, "native_loader_available", lambda: False)
        mp.setattr(port_native_loader, "native_loader_available", lambda: False)
        cmc_p, map_p = port_evaluate.main(
            port_evaluate.build_argparser().parse_args(common + ["--device", "cpu"]))["Synthetic"]
        cmc_j, map_j = jax_evaluate.main(jax_evaluate.build_argparser().parse_args(common))["Synthetic"]
    assert "[Synthetic] mAP" in capsys.readouterr().out
    one_query = 1.0 / len(world["splits"]["query"])
    assert abs(float(cmc_p[0]) - float(cmc_j[0])) <= one_query
    assert abs(map_p - float(map_j)) <= one_query
    assert cmc_p.shape == (50,)


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the int8 CPU path's many small ops: beside
    the other workers of a parallel test run, OpenMP's eight threads a
    worker oversubscribe the cores and an int8 CLI run takes minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_registries(mp):
    mp.setitem(jax_factory.MODEL_REGISTRY, "resnet50",
               lambda dtype=jnp.float32, **kw: (FlaxResNet(stage_sizes=STAGES, dtype=dtype), 2048))
    mp.setitem(port_factory.MODEL_REGISTRY, "resnet50",
               lambda dtype, **kw: (ResNet50ReID(stage_sizes=STAGES, dtype=dtype), 2048))
    mp.setattr(jax_native_loader, "native_loader_available", lambda: False)
    mp.setattr(port_native_loader, "native_loader_available", lambda: False)


def test_evaluate_cli_int8_matches_jax(world, one_torch_thread):
    """``--quantize int8 --calib_batches 2`` (the query split's 32 images are
    two batches of 16): both packages calibrate on the same images and rank
    with int8 embeddings; R1 and mAP within one query's weight, as in the
    float32 case (measured on the CPU: R1 1.0 in both, mAP 0.9741319444
    against 0.9741319418, the JAX package's float32 AP sum)."""
    common = ["--targets", "Synthetic", "--data_root", world["root"], "--model_name", "resnet50",
              "--model_path", world["weights"], "--img_height", str(IMG[0]),
              "--img_width", str(IMG[1]), "--batch_size", "16", "--compute_dtype", "float32",
              "--quantize", "int8", "--calib_batches", "2"]
    with pytest.MonkeyPatch.context() as mp:
        _tiny_registries(mp)
        cmc_p, map_p = port_evaluate.main(
            port_evaluate.build_argparser().parse_args(common + ["--device", "cpu"]))["Synthetic"]
        cmc_j, map_j = jax_evaluate.main(jax_evaluate.build_argparser().parse_args(common))["Synthetic"]
    one_query = 1.0 / len(world["splits"]["query"])
    assert abs(float(cmc_p[0]) - float(cmc_j[0])) <= one_query
    assert abs(map_p - float(map_j)) <= one_query


def test_search_cli_int8_matches_jax(world, one_torch_thread):
    """``search --quantize int8 --index_quantize int8``: the int8 extractor
    (calibrated on the gallery's first batch, then used for the probes) and
    the SQ8 index; the same top-1 identities and top-5 similarities within
    1e-3 (the int8 embeddings of the two packages differ within float32
    summation order, which a quantize can follow by one step)."""
    from daliid_tpu.cli import search as jax_search
    from daliid_tpu_torch.cli import search as port_search

    common = ["--dataset", "Synthetic", "--data_root", world["root"], "--model_name", "resnet50",
              "--model_path", world["weights"], "--img_height", str(IMG[0]),
              "--img_width", str(IMG[1]), "--batch_size", "16", "--compute_dtype", "float32",
              "--quantize", "int8", "--index_quantize", "int8", "--topk", "5"]
    with pytest.MonkeyPatch.context() as mp:
        _tiny_registries(mp)
        sims_p, _, pids_p = port_search.main(
            port_search.build_argparser().parse_args(common + ["--device", "cpu"]))
        sims_j, _, pids_j = jax_search.main(jax_search.build_argparser().parse_args(common))
    np.testing.assert_array_equal(pids_p[:, 0], np.asarray(pids_j)[:, 0])
    np.testing.assert_allclose(sims_p, np.asarray(sims_j), atol=1e-3, rtol=0)


def test_serve_int8_extractor_answers_like_jax(world, tmp_path, one_torch_thread):
    """A daemon whose extractor is int8 (``serve --quantize int8``): the first
    request by path calibrates it; enroll and search by path against the
    JAX daemon with its int8 extractor: the same top-1 identities,
    similarities within 1e-3."""
    bundle = port_evaluate.load_bundle("resnet50", world["weights"], IMG, torch.float32, "cpu")
    port_q = FeatureExtractor(bundle, img_size=IMG, batch_size=16, device="cpu",
                              quantize="int8")
    jax_q = JaxExtractor(world["jax_extractor"].bundle, img_size=IMG, batch_size=16,
                         quantize="int8")
    flags = ["--port", "0", "--index_quantize", "int8", "--data_dir", str(tmp_path)]
    ps, pt, pc = _start(port_serve, flags + ["--device", "cpu", "--quantize", "int8"], port_q)
    js, jt, jc = _start(jax_serve, flags + ["--quantize", "int8"], jax_q)
    try:
        gallery, query = world["splits"]["gallery"], world["splits"]["query"]
        rp, rj = _both((pc, jc), {"op": "enroll", "paths": [str(p) for p in gallery.paths],
                                  "pids": gallery.pids.tolist()})
        assert rp == rj and port_q.quant_scales is not None and port_q._calib_final
        rp, rj = _both((pc, jc), {"op": "search", "paths": [str(p) for p in query.paths],
                                  "topk": 5})
        np.testing.assert_array_equal(np.asarray(rp["pids"])[:, 0], np.asarray(rj["pids"])[:, 0])
        np.testing.assert_allclose(rp["sims"], rj["sims"], atol=1e-3, rtol=0)
    finally:
        _stop(ps, pt, pc)
        _stop(js, jt, jc)


def test_evaluate_cli_rejects_unported_flags(world):
    parse = port_evaluate.build_argparser().parse_args
    # the multi-process flags and --sharded_eval are ported
    # (tests/test_torch_distributed.py): --multihost without the gang's
    # address is refused, and --sharded_eval ranks like the replicated path
    with pytest.raises(SystemExit, match="--multihost needs --coordinator_address"):
        port_evaluate.main(parse(["--targets", "Synthetic", "--device", "cpu", "--multihost"]))
    base = ["--targets", "Synthetic", "--device", "cpu", "--data_root", world["root"],
            "--model_path", world["weights"], "--img_height", str(IMG[0]), "--img_width",
            str(IMG[1]), "--compute_dtype", "float32", "--batch_size", "16"]
    sharded = port_evaluate.main(parse(base + ["--sharded_eval"]))["Synthetic"]
    replicated = port_evaluate.main(parse(base + ["--no-sharded_eval"]))["Synthetic"]
    np.testing.assert_array_equal(sharded[0], replicated[0])
    assert abs(sharded[1] - replicated[1]) < 1e-12
    # the turbulence and manifest flags are ported (tests/test_torch_datasets.py):
    # a manifest flag without the rest of its trio is refused as in JAX
    with pytest.raises(SystemExit, match="must be given together"):
        port_evaluate.main(parse(["--targets", "Synthetic", "--device", "cpu",
                                  "--queries_file_path", "x"]))
