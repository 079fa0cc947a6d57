"""The port's program spans (``utils/profiling.py::span``) in the epoch loop
and in extraction, on the CPU.

- while no profiler records, a span keeps no record and opens no
  ``record_function`` range;
- tracing is inert: a tiny ``Trainer`` trained for two epochs, and a
  ``FeatureExtractor`` on a tiny table, give bit-equal weights, EMA, mined
  proxies, step metrics and embeddings inside ``torch.profiler.profile``
  and outside it;
- the spans carry the names, threads, parents and counts the benchmark's
  readers (``benchmark/harness/program_spans.py``) rely on;
- each record lies inside the profiler's host event of the same name (the
  two share one clock);
- the methods the benchmark's check replaces on the instance are called as
  often with tracing on as off.
"""

import collections
import copy
import threading

import numpy as np
import pytest
import torch
from torch import nn
from torch._C._profiler import _ExperimentalConfig

from daliid_tpu_torch.data import make_synthetic_dataset
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.models.factory import ModelBundle
from daliid_tpu_torch.models.norm import TorchBatchNorm
from daliid_tpu_torch.train.sampler import PKBatchSampler
from daliid_tpu_torch.train.trainer import Trainer
from daliid_tpu_torch.utils import profiling
from daliid_tpu_torch.utils.profiling import span, span_records

IMG = (32, 16)
EPOCHS = 2
# the methods the benchmark's check replaces on the instance
PATCHED = ("_stage", "augment", "train_step", "mine_proxies", "forward_backward")


class _TinyConv(nn.Module):
    dtype = torch.float32

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.bn = TorchBatchNorm(8)
        self.proj = nn.Linear(8, 16)

    def forward(self, x):
        x = torch.relu(self.bn(self.conv(x.float())))
        return self.proj(x.mean(dim=(2, 3)))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_tracing_data")
    splits, turb = make_synthetic_dataset(str(root), num_ids=4, imgs_per_id_train=3,
                                          imgs_per_id_test=2, height=IMG[0], width=IMG[1])
    return splits["train"], turb


def _trainer(synth):
    table, turb = synth
    torch.manual_seed(0)
    model = _TinyConv()
    online = ModelBundle(module=model, feature_dim=16, name="tiny")
    momentum = ModelBundle(module=copy.deepcopy(model), feature_dim=16, name="tiny")
    sampler = PKBatchSampler(table, table.pids, P=2, K=4, kind_of_transform=1,
                             turbulence_dir=turb, seed=5)
    return Trainer(online, momentum, sampler, img_size=IMG, base_lr=1e-3, tau=0.05,
                   beta=0.9, lambda_proxy=0.4, num_epochs=4, num_proxies=3, seed=5,
                   compute_dtype=torch.float32, decode_workers=2, extractor_batch=8)


def _profiled(traced: bool):
    if not traced:
        return None
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  experimental_config=_ExperimentalConfig(
                                      profile_all_threads=True))


def _count_calls(trainer, calls):
    """Replace the patched methods on the instance by counting wrappers,
    as the benchmark's check does."""
    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for name in PATCHED:
        setattr(trainer, name, counted(name, getattr(trainer, name)))
    trainer.optimizer.step = counted("optimizer.step", trainer.optimizer.step)
    trainer.extractor.extract = counted("extractor.extract", trainer.extractor.extract)


def _train(synth, traced: bool):
    """Two epochs of a tiny trainer → (weights, EMA, proxy sets, step
    metrics, the calls of the patched methods, the records it added, the
    profiler)."""
    trainer = _trainer(synth)
    calls = collections.Counter()
    _count_calls(trainer, calls)
    psets, metrics = [], []
    mine = trainer.mine_proxies

    def keep(*a, **kw):
        psets.append(mine(*a, **kw))
        return psets[-1]

    trainer.mine_proxies = keep
    before = {r.id for r in span_records()}
    prof = _profiled(traced)
    if prof is not None:
        prof.__enter__()
    try:
        for epoch in range(1, EPOCHS + 1):
            metrics.append(trainer.train_epoch(epoch))
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    added = [r for r in span_records() if r.id not in before]
    return (trainer.online.state_dict(), trainer.momentum.state_dict(), psets, metrics, calls,
            added, prof, trainer)


@pytest.fixture(scope="module")
def runs(synth):
    return {traced: _train(synth, traced) for traced in (False, True)}


def test_no_record_and_no_range_while_no_profiler_records(runs, synth, monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert span("a", n=3) is span("b") is profiling.trace_annotation("c")
    assert runs[False][5] == []
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **kw: opened.append(a) or real(*a, **kw))
    table, _ = synth
    before = len(span_records())
    FeatureExtractor(ModelBundle(module=_TinyConv(), feature_dim=16, name="tiny"), img_size=IMG,
                     batch_size=8, decode_workers=2).extract(table)
    with profiling.phase("outside"):
        pass
    assert opened == [] and len(span_records()) == before


def test_tracing_leaves_training_bit_equal(runs):
    off, on = runs[False], runs[True]
    for a, b in ((off[0], on[0]), (off[1], on[1])):
        assert list(a) == list(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert len(off[2]) == len(on[2]) == EPOCHS
    for p, q in zip(off[2], on[2]):
        for field in ("centers", "proxies", "proxy_labels"):
            np.testing.assert_array_equal(getattr(p, field), getattr(q, field))
        assert (p.min_inter, p.mean_max_intra) == (q.min_inter, q.mean_max_intra)
    for m, n in zip(off[3], on[3]):
        m, n = dict(m), dict(n)
        m.pop("epoch_seconds"), n.pop("epoch_seconds")
        assert m == n


def test_tracing_leaves_extraction_bit_equal(synth):
    table, _ = synth
    torch.manual_seed(1)
    ex = FeatureExtractor(ModelBundle(module=_TinyConv(), feature_dim=16, name="tiny"),
                          img_size=IMG, batch_size=5, decode_workers=2)
    plain = ex.extract(table)
    before = {r.id for r in span_records()}
    with _profiled(True):
        traced = ex.extract(table)
    np.testing.assert_array_equal(plain, traced)
    added = [r for r in span_records() if r.id not in before]
    decode = [r for r in added if r.name == "extract.decode"]
    assert sum(r.n for r in decode) == len(table) and len(decode) == -(-len(table) // 5)
    # no span was open at the call: the producer's spans are roots
    assert {r.parent for r in decode} == {None}
    waits = [r for r in added if r.name == "extract.wait"]
    assert len(waits) == len(decode) + 1  # the last get takes the end marker
    copies = [r for r in added if r.name == "extract.copy"]
    assert [r.n for r in copies] == [len(table)]


def test_spans_have_their_names_threads_parents_and_counts(runs):
    *_, added, _, trainer = runs[True]
    main = threading.get_ident()  # the thread the trainer ran on
    by_id = {r.id: r for r in added}
    by_name = collections.defaultdict(list)
    for r in added:
        by_name[r.name].append(r)

    def parent(r):
        return by_id[r.parent].name if r.parent is not None else None

    table = trainer.sampler.table
    steps = trainer.sampler.batches_per_epoch()
    batch = trainer.sampler.batch_size
    want = {
        # name: (on the main thread, parent, count of spans, count n of each)
        "proxy_mining": (True, None, EPOCHS, None),
        "finetuning": (True, None, EPOCHS, None),
        "mine.extract": (True, "proxy_mining", EPOCHS, len(table)),
        "mine.host": (True, "proxy_mining", EPOCHS, trainer.sampler.num_classes),
        "extract.wait": (True, "mine.extract", None, None),
        "extract.copy": (True, "mine.extract", EPOCHS, len(table)),
        "extract.decode": (False, "mine.extract", None, None),
        # later minings run over the batches the first one kept
        "extract.kept": (True, "mine.extract", EPOCHS - 1, len(table)),
        "train.prefetch_wait": (True, "finetuning", EPOCHS * steps, None),
        "train.step": (True, "finetuning", EPOCHS * steps, batch),
        "train.decode": (False, "finetuning", EPOCHS * steps, batch),
    }
    assert set(by_name) == set(want)
    for name, (on_main, par, count, n) in want.items():
        recs = by_name[name]
        assert {r.thread == main for r in recs} == {on_main}, name
        assert {parent(r) for r in recs} == {par}, name
        if count is not None:
            assert len(recs) == count, name
        if n is not None:
            assert {r.n for r in recs} == {n}, name
        assert all(r.start_ns <= r.end_ns for r in recs)
    # the first mining decodes the table once, later ones decode nothing;
    # an epoch decodes its batch slots
    first, *later = sorted(by_name["mine.extract"], key=lambda r: r.start_ns)
    for m in (first, *later):
        inside = [r for r in by_name["extract.decode"] if r.parent == m.id]
        assert sum(r.n for r in inside) == (m.n if m is first else 0)
    for f in by_name["finetuning"]:
        inside = [r for r in by_name["train.decode"] if r.parent == f.id]
        assert sum(r.n for r in inside) == steps * batch
        assert all(f.start_ns <= r.start_ns and r.end_ns <= f.end_ns for r in inside)
    # children lie inside their parent on the main thread
    for r in added:
        if r.parent is not None and r.thread == main:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, r.name


def test_each_record_lies_inside_the_profilers_event_of_its_name(runs):
    *_, added, prof, _ = runs[True]
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            events[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    recs = collections.defaultdict(list)
    for r in added:
        recs[r.name].append(r)
    slack = 1_000_000  # 1 ms
    for name, rs in recs.items():
        evs = sorted(events[name])
        assert len(evs) == len(rs), name
        for r in rs:
            assert any(s - slack <= r.start_ns and r.end_ns <= e + slack for s, e in evs), name


def test_the_checks_patch_points_are_called_as_often_traced(runs):
    off, on = runs[False][4], runs[True][4]
    assert set(off) == set(PATCHED) | {"optimizer.step", "extractor.extract"}
    assert off == on
    assert on["mine_proxies"] == on["extractor.extract"] == EPOCHS
