"""Traffic kind ``evaluate_protocol``: model evaluations back to back.

One evaluation is the evaluation core of the program's ``evaluate`` CLI:
``FeatureExtractor.extract`` of the query and of the gallery from their
JPEGs (the decode thread, the fixed extraction batch with a padded tail),
``cosine_distance_matrix`` on the device and ``evaluate_rank`` (kernel K2)
for the CMC and mAP. Set-up writes the Market-shaped query and gallery
tree, builds the model from the seeded weights and runs one evaluation,
which warms every shape. The window runs evaluations while ``--seconds``
have not passed; ``eval_s`` is the time from the window's start to the end
of the last evaluation that completed in it, over their number.

The check judges the window's last evaluation: a seeded sample of its
embeddings against the reference's float32 forward of the same JPEGs, and
its CMC and mAP against the reference's ranking of the program's own
embeddings, whose float32 distances it works out again with the same
formula over the whole matrix at once, so that the order, ties included,
is the program's: the CMC, as counts of queries, must be equal, the mAP
equal to the rounding of its float64 sum (the ranking follows the program's embeddings; the embeddings are
checked against the reference by themselves).
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from benchmark.harness import datagen, models, tracing
from benchmark.harness.compare import row_gap
from benchmark.reference import ranking as ref_ranking
from benchmark.reference.precision import Precision, set_strict_float32
from benchmark.traffic.train_epochs import reference_embed


def _fault(run, extractor) -> None:
    """The benchmark's own tests break the timed path underneath."""
    if run.fault == "half_batch":
        ex = extractor.extract

        def half(table, *a, **kw):
            out = ex(table, *a, **kw)
            out[len(out) // 2:] = 0.0
            return out

        extractor.extract = half
    elif run.fault == "altered_answer":
        import daliid_tpu_torch.metrics.ranking as rk
        orig = rk.evaluate_rank

        def altered(*a, **kw):
            cmc, m = orig(*a, **kw)
            return cmc * 0.9, m * 0.9

        run._restore = lambda: setattr(rk, "evaluate_rank", orig)
        rk.evaluate_rank = altered


def k2_valid(q_pids, g_pids, q_cams, g_cams) -> int:
    """Counted positives of the protocol: gallery entries of the query's
    identity from another camera."""
    n = 0
    for p, c in zip(q_pids, q_cams):
        n += int(((g_pids == p) & (g_cams != c)).sum())
    return n


def run(run) -> None:
    import daliid_tpu_torch.metrics.ranking as rk
    from daliid_tpu_torch.data.registry import parse_market_duke_dir
    from daliid_tpu_torch.eval.features import FeatureExtractor

    p, cfg = run.params, run.config
    dev = torch.device(run.device)
    run.mark("imports")
    root = datagen.make_tree(str(run.cache / "data"), run.workload["traffic"], p["tree"],
                             run.seed, 2 * (os.cpu_count() or 1))
    queries = parse_market_duke_dir(os.path.join(root, "query"))
    gallery = parse_market_duke_dir(os.path.join(root, "bounding_box_test"))
    run.mark("tree")
    weights = models.make_weights(cfg, run.seed, dev)
    bundle = models.build_program(cfg, weights, dev)
    extractor = FeatureExtractor(bundle, img_size=tuple(cfg["img_size"]),
                                 batch_size=p["batch_size"], device=dev,
                                 quantize=p.get("quantize"))
    _fault(run, extractor)

    def evaluate():
        t = time.time()
        q = extractor.extract(queries)
        g = extractor.extract(gallery)
        t_mid = time.time()
        dist = rk.cosine_distance_matrix(torch.as_tensor(q, device=dev),
                                         torch.as_tensor(g, device=dev))
        cmc, m_ap = rk.evaluate_rank(dist, queries.pids, gallery.pids, queries.camids,
                                     gallery.camids)
        del dist
        return q, g, cmc, m_ap, t_mid - t, time.time() - t_mid

    run.mark("weights and model")
    evaluate()
    run.mark("warm-up: one evaluation")
    t0 = time.time()
    run.setup_s = t0 - run.t_start
    n, t_last, extract_s, rank_s, last, dur = 0, t0, 0.0, 0.0, None, 0.0
    with tracing.profiled(run.trace) as prof:
        # an evaluation starts only while it would end inside the window
        while n == 0 or time.time() - t0 + dur <= run.seconds:
            ts = time.time()
            last = evaluate()
            t_last = time.time()
            dur = t_last - ts
            run.note(f"evaluation {n + 1}: {dur:.3f} s")
            extract_s += last[4]
            rank_s += last[5]
            n += 1
    run.window_s = t_last - t0
    if prof is not None:
        run.tracer = tracing.summarize(prof, run.window_s)
    run.metrics["eval_s"] = run.window_s / n
    images = len(queries) + len(gallery)
    run.spans.update(extract=extract_s, rank=rank_s)
    run.counts.update(evaluations=n, images=n * images,
                      extract_batches=n * sum(-(-len(t) // p["batch_size"])
                                                 for t in (queries, gallery)))
    qp, gp = np.asarray(queries.pids), np.asarray(gallery.pids)
    qc, gc_ = np.asarray(queries.camids), np.asarray(gallery.camids)
    run.shapes.update(k2=(len(queries), len(gallery), rk.queried_positives_bound(qp, gp),
                          k2_valid(qp, gp, qc, gc_)),
                      extract_batch=p["batch_size"],
                      attention=models.reference(cfg).attention(cfg))
    run.attempted = n
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    if hasattr(run, "_restore"):
        run._restore()
    q, g, cmc, m_ap = last[:4]
    del extractor, bundle
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(run, queries, gallery, weights, q, g, cmc, m_ap)
    run.mark("the check")


def check(run, queries, gallery, weights, q, g, cmc, m_ap,
          prec: Precision | None = None) -> None:
    set_strict_float32()
    prec = prec or Precision("f32")
    rng = np.random.default_rng(run.seed)
    k = run.params["check_rows"] // 2
    qi = rng.choice(len(queries), min(k, len(queries)), replace=False)
    gi = rng.choice(len(gallery), min(k, len(gallery)), replace=False)
    paths = [str(queries.paths[i]) for i in qi] + [str(gallery.paths[i]) for i in gi]
    ref = reference_embed(run, weights, paths, prec)
    run.mark("the check: the reference's embeddings")
    run.check("embed_gap", row_gap(np.concatenate([q[qi], g[gi]]), ref))
    dev = next(iter(weights.values())).device
    cmc_ref, map_ref, n = ref_ranking.evaluate(q, g, queries.pids, gallery.pids,
                                               queries.camids, gallery.camids, device=dev)
    run.mark("the check: the reference's ranking")
    # the CMC as counts of queries: exact; the mAP to the rounding of a
    # float64 sum over the queries
    run.check("cmc_gap", float(np.abs(np.rint(np.asarray(cmc) * n) - np.rint(cmc_ref * n)).max()))
    run.check("map_gap", abs(float(m_ap) - map_ref))
