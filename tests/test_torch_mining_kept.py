"""Mining's kept batches (``FeatureExtractor.extract(keep=True)``), on the CPU.

The trainer's mining asks the extractor to keep the train table's decoded,
padded uint8 batches on the device; every later mining of the same table
runs the forward over them. Held here:

- over 3 epochs of a tiny Market-shaped tree whose table does not fill its
  last batch, mining with kept batches gives embeddings, centers, proxies,
  proxy labels and weights bit-equal to mining that decodes every epoch
  (the memory probe patched to say the table does not fit), for a tiny
  ResNet, a tiny TransReID-JPM with camera ids, and the int8 mining
  extractor; only the first mining decodes;
- a wrapper around the mining extractor's ``extract`` in the benchmark's
  style sees the table and the features once per mining;
- with a profiler on, later minings keep an ``extract.kept`` span (``n``
  the table's rows) and no ``extract.decode``; where the table does not
  fit, every mining decodes and no ``extract.kept`` is recorded;
- the memory rule: the table's padded bytes against ``KEEP_SHARE`` of the
  probe's free bytes;
- another path list, or the turbulence rewrite of the same list, is never
  served from the kept copy; an extract without ``keep`` takes the decode
  path and leaves the kept copy alone.
"""

import collections
import copy

import numpy as np
import pytest
import torch
from torch import nn
from torch._C._profiler import _ExperimentalConfig

from daliid_tpu_torch.data import make_synthetic_dataset
from daliid_tpu_torch.eval import features
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.models.factory import ModelBundle
from daliid_tpu_torch.models.resnet import ResNet50ReID
from daliid_tpu_torch.models.transreid_jpm import TransReIDJPM
from daliid_tpu_torch.train.sampler import PKBatchSampler
from daliid_tpu_torch.train.trainer import Trainer
from daliid_tpu_torch.utils.profiling import span_records

IMG = (32, 16)
EPOCHS = 3
BATCH = 8  # 12 train images: the second batch holds 4 real rows
JPM = dict(patch_size=8, patch_stride=6, embed_dim=32, depth=2, num_heads=2,
           drop_path_rate=0.0, sie_cameras=4, num_classes=4)
KINDS = ("resnet", "jpm", "int8")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mining_kept")
    splits, turb = make_synthetic_dataset(str(root), num_ids=4, imgs_per_id_train=3,
                                          imgs_per_id_test=2, height=IMG[0], width=IMG[1])
    table = splits["train"]
    table.name = "Market"
    assert len(table) % BATCH
    return table, turb


def _model(kind: str):
    torch.manual_seed(0)
    if kind == "jpm":
        return TransReIDJPM(img_size=IMG, **JPM), 5 * JPM["embed_dim"]
    return ResNet50ReID(stage_sizes=(1, 1, 1, 1)), 2048


def _trainer(kind: str, synth) -> Trainer:
    table, turb = synth
    model, dim = _model(kind)
    online = ModelBundle(module=model, feature_dim=dim, name=kind)
    momentum = ModelBundle(module=copy.deepcopy(model), feature_dim=dim, name=kind)
    sampler = PKBatchSampler(table, table.pids, P=2, K=4, kind_of_transform=1,
                             turbulence_dir=turb, dataset="Market", seed=5)
    extra = dict(mining_quantize="int8", mining_calib_batches=2) if kind == "int8" else {}
    return Trainer(online, momentum, sampler, img_size=IMG, base_lr=1e-3, tau=0.05,
                   beta=0.9, lambda_proxy=0.4, num_epochs=4, num_proxies=3, seed=5,
                   compute_dtype=torch.float32, decode_workers=2, extractor_batch=BATCH,
                   **extra)


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  experimental_config=_ExperimentalConfig(
                                      profile_all_threads=True))


def _train(kind: str, synth, fits: bool, traced: bool) -> dict:
    """EPOCHS epochs of a tiny trainer, with the memory probe saying the
    table fits or not → what each mining extracted and mined, the rows it
    decoded, the weights, and the span records it added."""
    with pytest.MonkeyPatch.context() as m:
        if not fits:
            m.setattr(features, "free_memory_bytes", lambda device: 0)
        tr = _trainer(kind, synth)
        ex = tr._mining_extractor or tr.extractor
        seen, psets, decoded = [], [], []
        # the benchmark's style of wrapper: the instance's extract replaced
        extract, decode, mine = ex.extract, ex._decode_paths, tr.mine_proxies

        def wrapped(table, *a, **kw):
            out = extract(table, *a, **kw)
            seen.append((table, kw, out))
            return out

        def counted(paths):
            decoded.append(len(paths))
            return decode(paths)

        def mined(*a, **kw):
            psets.append(mine(*a, **kw))
            return psets[-1]

        ex.extract, ex._decode_paths, tr.mine_proxies = wrapped, counted, mined
        before = {r.id for r in span_records()}
        prof = _profiled() if traced else None
        if prof is not None:
            prof.__enter__()
        try:
            for epoch in range(1, EPOCHS + 1):
                tr.train_epoch(epoch)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        return dict(trainer=tr, seen=seen, psets=psets, decoded=sum(decoded),
                    online=tr.online.state_dict(), momentum=tr.momentum.state_dict(),
                    records=[r for r in span_records() if r.id not in before],
                    kept=ex._kept)


@pytest.fixture(scope="module")
def runs(synth):
    return {(kind, fits): _train(kind, synth, fits, traced=kind == "resnet")
            for kind in KINDS for fits in (True, False)}


@pytest.mark.parametrize("kind", KINDS)
def test_kept_mining_is_bit_equal_to_decoding_every_epoch(runs, synth, kind):
    kept, decoded = runs[(kind, True)], runs[(kind, False)]
    table, _ = synth
    assert len(kept["psets"]) == len(decoded["psets"]) == EPOCHS
    for (_, _, a), (_, _, b) in zip(kept["seen"], decoded["seen"]):
        assert a.shape == (len(table), kept["trainer"].extractor.bundle.feature_dim)
        np.testing.assert_array_equal(a, b)
    for p, q in zip(kept["psets"], decoded["psets"]):
        for field in ("centers", "proxies", "proxy_labels"):
            np.testing.assert_array_equal(getattr(p, field), getattr(q, field))
        assert (p.min_inter, p.mean_max_intra) == (q.min_inter, q.mean_max_intra)
    for side in ("online", "momentum"):
        assert list(kept[side]) == list(decoded[side])
        for k in kept[side]:
            assert torch.equal(kept[side][k], decoded[side][k]), (side, k)
    # the minings' embeddings moved with the weights: the kept bytes met new weights
    assert not np.array_equal(kept["seen"][0][2], kept["seen"][-1][2])
    # only the first mining decoded; the kept copy holds every padded batch
    assert kept["decoded"] == len(table) and decoded["decoded"] == EPOCHS * len(table)
    assert decoded["kept"] is None
    batches = kept["kept"].batches
    assert len(batches) == -(-len(table) // BATCH)
    assert [int(b[0].shape[0]) for b in batches] == [BATCH] * len(batches)
    assert [b[2] for b in batches] == [BATCH, len(table) % BATCH]
    assert not batches[-1][0][len(table) % BATCH:].any()  # zero padding, as decoded


@pytest.mark.parametrize("kind", KINDS)
def test_a_wrapper_around_extract_sees_the_table_and_features_once_a_mining(runs, kind):
    run = runs[(kind, True)]
    assert len(run["seen"]) == EPOCHS
    for (table, kw, feats), pset in zip(run["seen"], run["psets"]):
        assert table is run["trainer"].sampler.table
        assert kw.get("keep") is True
        assert feats.dtype == np.float32 and np.isfinite(feats).all()
    assert len(run["psets"]) == EPOCHS


def test_kept_minings_record_extract_kept_and_no_decode(runs, synth):
    table, _ = synth
    by_mining = collections.defaultdict(collections.Counter)
    recs = runs[("resnet", True)]["records"]
    by_id = {r.id: r for r in recs}
    minings = sorted((r for r in recs if r.name == "mine.extract"), key=lambda r: r.start_ns)
    assert len(minings) == EPOCHS
    for r in recs:
        if r.name.startswith("extract."):
            by_mining[r.parent][r.name] += r.n or 0
    first, *later = minings
    assert by_mining[first.id]["extract.decode"] == len(table)
    assert "extract.kept" not in by_mining[first.id]
    for m in later:
        assert by_mining[m.id]["extract.kept"] == len(table)
        assert "extract.decode" not in by_mining[m.id]
        assert "extract.wait" not in by_mining[m.id]
    kept = [r for r in recs if r.name == "extract.kept"]
    assert len(kept) == EPOCHS - 1
    assert all(by_id[r.parent].name == "mine.extract" for r in kept)


def test_a_table_that_does_not_fit_decodes_every_mining_and_records_no_kept_span(runs, synth):
    table, _ = synth
    recs = runs[("resnet", False)]["records"]
    assert not [r for r in recs if r.name == "extract.kept"]
    decode = [r for r in recs if r.name == "extract.decode"]
    assert sum(r.n for r in decode) == EPOCHS * len(table)


class _TinyConv(nn.Module):
    dtype = torch.float32

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.proj = nn.Linear(8, 16)

    def forward(self, x):
        return self.proj(torch.relu(self.conv(x.float())).mean(dim=(2, 3)))


def _extractor(batch_size: int = 5) -> FeatureExtractor:
    torch.manual_seed(1)
    return FeatureExtractor(ModelBundle(module=_TinyConv(), feature_dim=16, name="tiny"),
                            img_size=IMG, batch_size=batch_size, decode_workers=2)


def _traced_extract(ex, *a, **kw):
    """(embeddings, {span name: summed n}) of one extract under a profiler."""
    before = {r.id for r in span_records()}
    with _profiled():
        out = ex.extract(*a, **kw)
    counts = collections.Counter()
    for r in span_records():
        if r.id not in before:
            counts[r.name] += r.n if r.n is not None else 1
    return out, counts


def test_the_memory_rule_keeps_only_what_fits_the_share_of_free_memory(synth, monkeypatch):
    table, _ = synth
    padded = -(-len(table) // 5) * 5 * IMG[0] * IMG[1] * 3
    assert features.free_memory_bytes(torch.device("cpu")) > 0
    for free, keeps in ((padded / features.KEEP_SHARE, True),
                        (padded / features.KEEP_SHARE - 1, False)):
        asked = []
        monkeypatch.setattr(features, "free_memory_bytes",
                            lambda device, free=free: asked.append(device) or free)
        ex = _extractor()
        ex.extract(table, keep=True)
        assert (ex._kept is not None) == keeps
        assert asked == [ex.device]
        _, counts = _traced_extract(ex, table, keep=True)
        assert ("extract.kept" in counts) == keeps and ("extract.decode" in counts) != keeps


def test_another_path_list_or_its_turbulence_is_never_served_from_the_kept_copy(synth):
    table, turb = synth
    ex = _extractor()
    plain = ex.extract(table)
    kept, counts = _traced_extract(ex, table, keep=True)
    np.testing.assert_array_equal(kept, plain)
    assert counts["extract.decode"] == len(table) and "extract.kept" not in counts
    again, counts = _traced_extract(ex, table, keep=True)
    np.testing.assert_array_equal(again, plain)
    assert counts["extract.kept"] == len(table) and "extract.decode" not in counts

    # another list (the same paths but the first): decoded, and replaces the copy
    others = [str(p) for p in table.paths[1:]]
    want = ex.extract(others)
    got, counts = _traced_extract(ex, others, keep=True)
    np.testing.assert_array_equal(got, want)
    assert counts["extract.decode"] == len(others) and "extract.kept" not in counts
    assert ex._kept.key[0] == others

    # the turbulence rewrite of the table's own list
    want = ex.extract(table, turbulence_dir=turb, turb_strength=3)
    assert not np.array_equal(want, plain)
    for _ in range(2):
        ex.extract(table, keep=True)  # the table's copy again
        got, counts = _traced_extract(ex, table, keep=True, turbulence_dir=turb,
                                      turb_strength=3)
        np.testing.assert_array_equal(got, want)
        assert counts["extract.decode"] == len(table) and "extract.kept" not in counts
    # and back: the turbulence copy is not the table's
    got, counts = _traced_extract(ex, table, keep=True)
    np.testing.assert_array_equal(got, plain)
    assert counts["extract.decode"] == len(table) and "extract.kept" not in counts


def test_an_extract_without_keep_decodes_and_leaves_the_kept_copy(synth):
    table, _ = synth
    ex = _extractor()
    first = ex.extract(table, keep=True)
    kept = ex._kept
    got, counts = _traced_extract(ex, table)
    np.testing.assert_array_equal(got, first)
    batches = -(-len(table) // 5)
    # the producer path as before: one decode a batch, one wait a batch and one for the end
    assert counts == {"extract.decode": len(table), "extract.wait": batches + 1,
                      "extract.copy": len(table)}
    assert ex._kept is kept
    _, counts = _traced_extract(ex, table, keep=True)
    assert counts == {"extract.kept": len(table), "extract.copy": len(table)}
