"""The training slice of the PyTorch port against the JAX package, on the CPU.

Both sides start from the same weights (the flax model's variables carried
into the port by ``variables_from_jax``) and see the same data (numpy-made
batches, the same JPEGs, the same sampler seeds). The tiny
``ResNet50ReID(stage_sizes=(1, 1, 1, 1))`` in f32 at 32x16 stands in for
ResNet-50; the JAX trainer runs on the tests' 8-device CPU mesh, so every
batch is a multiple of 8 slots and nothing is padded to the mesh.

Tolerances, each with its reason:

- losses and diagnostics of one step: rtol 1e-4 (f32 convolutions in
  another summation order; measured about 1e-7 relative);
- Adam moments ``mu`` / ``nu`` and BN running statistics: atol 1e-5
  (measured 3e-7, 2e-9 and 2e-6);
- parameters after the step: atol 1e-5 = lr / 100, and the EMA's 1e-6, on
  every element whose effective gradient g + wd*p exceeds 1e-6 (|mu| > 1e-7).
  Adam's first update is lr * g / (|g| + 1e-8), about lr * sign(g): where g is
  within the two sides' gradient difference (measured 3e-6 at most) of 0 the
  sign itself may differ, so those elements are excluded and counted (2.2%
  here; the test requires fewer than 5%);
- one epoch (mining and two steps): mean losses within rtol 1e-3 (measured
  5e-7); parameters within 2 * lr * steps everywhere (a flipped Adam sign
  moves an element by 2 * lr; measured 1.7e-3) and within 1e-4 on 95% of
  the elements (measured 99.9%; 97% within 1e-5).

A tiny ``densenet121`` (``block_sizes=(1, 1, 1, 1)``, ``growth=8``, a
4-class head, 64x32 images: its stride of 32 leaves no map at 32x16) is
registered under that name in both registries for its one-step lockstep,
with the classifier-headed loss branch: losses within rtol 1e-5, the
parameters as above. Its flax variables are initialized in train mode: the
JAX factory's eval-mode init creates no classifier, so the JAX package
cannot train this model through its own factory (flax raises
``ScopeParamNotFoundError`` at the first step); the port's model builds its
head at construction.
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from daliid_tpu.data.registry import ReidTable as JaxTable
from daliid_tpu.models import densenet as flax_densenet
from daliid_tpu.models import factory as jax_factory
from daliid_tpu.models.factory import ModelBundle as JaxBundle
from daliid_tpu.models.norm import TorchBatchNorm as FlaxBatchNorm
from daliid_tpu.models.resnet import ResNet50ReID as FlaxResNet
from daliid_tpu.ops.fused_augment import _augment_core
from daliid_tpu.train import proxies as jax_proxies
from daliid_tpu.train import trainer as jax_trainer
from daliid_tpu.train.sampler import PKBatchSampler as JaxSampler
from daliid_tpu_torch.augment import train_augment as train_augment_mod
from daliid_tpu_torch.data import make_synthetic_dataset
from daliid_tpu_torch import losses as port_losses
from daliid_tpu_torch.models import factory as port_factory
from daliid_tpu_torch.models.densenet import DenseNet121ReID
from daliid_tpu_torch.models.factory import ModelBundle
from daliid_tpu_torch.models.norm import TorchBatchNorm
from daliid_tpu_torch.models.resnet import ResNet50ReID
from daliid_tpu_torch.models.torch_port import load_state, params_from_jax, variables_from_jax
from daliid_tpu_torch.ops.fused_augment import draw_scalars, fused_augment_plain
from daliid_tpu_torch.train import checkpoint as ckpt_mod
from daliid_tpu_torch.train import trainer as port_trainer
from daliid_tpu_torch.train.proxies import mine_proxies_and_centers
from daliid_tpu_torch.train.sampler import PKBatchSampler

REPO = Path(__file__).resolve().parents[1]
IMG = (32, 16)
STAGES = (1, 1, 1, 1)
# one configuration for both trainers: paired batches of P=2 identities x
# K=4 images x 2 = 16 slots (3 images per identity, so one padded pair each)
TRAIN_KW = dict(img_size=IMG, base_lr=1e-3, weight_decay=5e-4, tau=0.05, beta=0.9,
                lambda_proxy=0.4, lambda_distortion=0.5, num_epochs=4, num_proxies=3, seed=5,
                extractor_batch=16)
P_, K_ = 2, 4


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_data")
    splits, turb = make_synthetic_dataset(str(root), num_ids=4, imgs_per_id_train=3,
                                          imgs_per_id_test=2, height=IMG[0], width=IMG[1])
    return splits["train"], turb


@pytest.fixture(scope="module")
def flax_variables():
    module = FlaxResNet(stage_sizes=STAGES)
    init = jax.jit(lambda key, x: module.init(key, x, train=False))
    return module, jax.tree.map(np.asarray, init(jax.random.key(0), jnp.zeros((1, *IMG, 3))))


@pytest.fixture(scope="module")
def jax_side(synth, flax_variables):
    """One JAX trainer for the module (its train step compiles once); each
    use resets its state and RNG streams."""
    table, turb = synth
    module, variables = flax_variables
    jt = JaxTable(table.paths, table.pids, table.camids, table.kinds, "Synthetic")
    sampler = JaxSampler(jt, jt.pids, P=P_, K=K_, kind_of_transform=1, turbulence_dir=turb,
                         seed=TRAIN_KW["seed"])
    online = JaxBundle(module=module, variables=variables, feature_dim=2048, name="tiny")
    momentum = JaxBundle(module=module, variables=jax.tree.map(np.copy, variables),
                         feature_dim=2048, name="tiny")
    trainer = jax_trainer.Trainer(online, momentum, sampler, compute_dtype=jnp.float32,
                                  **TRAIN_KW)

    def fresh():
        trainer.state = jax_trainer.TrainState(
            params=variables["params"], batch_stats=variables["batch_stats"],
            opt_state=trainer.optimizer.init(variables["params"]),
            momentum_params=jax.tree.map(np.copy, variables["params"]),
            momentum_batch_stats=jax.tree.map(np.copy, variables["batch_stats"]))
        trainer._rng = np.random.default_rng(TRAIN_KW["seed"])
        sampler._rng = np.random.default_rng(TRAIN_KW["seed"])
        return trainer

    return fresh


def _port_trainer(synth, variables, **over):
    table, turb = synth
    model = ResNet50ReID(stage_sizes=STAGES)
    model.load_state_dict(variables_from_jax("resnet50", variables), strict=True)
    online = ModelBundle(module=model, feature_dim=2048, name="tiny")
    momentum = ModelBundle(module=copy.deepcopy(model), feature_dim=2048, name="tiny")
    sampler = PKBatchSampler(table, table.pids, P=P_, K=K_, kind_of_transform=1,
                             turbulence_dir=turb, seed=TRAIN_KW["seed"])
    kw = {**TRAIN_KW, **over}
    return port_trainer.Trainer(online, momentum, sampler, compute_dtype=torch.float32,
                                decode_workers=2, **kw)


def _adam_moments(opt_state):
    found = []

    def walk(s):
        if hasattr(s, "mu") and hasattr(s, "nu"):
            found.append(s)
        elif isinstance(s, (tuple, list)):
            for x in s:
                walk(x)
        elif hasattr(s, "inner_state"):
            walk(s.inner_state)

    walk(opt_state)
    assert len(found) == 1
    return params_from_jax("resnet50", found[0].mu), params_from_jax("resnet50", found[0].nu)


def _max_err(port_sd, jax_sd, keys):
    return max(float((port_sd[k] - jax_sd[k]).abs().max()) for k in keys)


# ---------------------------------------------------------------- host parts
@pytest.mark.parametrize("paired", [True, False])
def test_sampler_emits_the_jax_batches(synth, paired):
    table, turb = synth
    jt = JaxTable(table.paths, table.pids, table.camids, table.kinds, "Synthetic")
    kw = dict(P=3, K=4, kind_of_transform=int(paired), turbulence_dir=turb if paired else None,
              seed=11)
    mine, theirs = PKBatchSampler(table, table.pids, **kw), JaxSampler(jt, jt.pids, **kw)
    for _ in range(2):
        got, want = list(mine.epoch()), list(theirs.epoch())
        assert len(got) == len(want) == 1
        for a, b in zip(got, want):
            assert a.paths == b.paths
            for name in ("labels", "distortions", "mask", "pids", "camids"):
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
            assert not a.mask.all()  # 3 images per identity, K = 4: padded slots


def test_mining_equals_jax_exactly():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(40, 24)).astype(np.float32)
    cls = np.repeat(np.arange(8), 5).astype(np.int32)
    cls[30:33] = 7  # classes of other sizes: 7 owns 8 samples, 6 owns 2
    got = mine_proxies_and_centers(feats, cls, 8, 4, np.random.default_rng(3))
    want = jax_proxies.mine_proxies_and_centers(feats, cls, 8, 4, np.random.default_rng(3))
    for name in ("centers", "proxies", "proxy_labels"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.mean_max_intra == want.mean_max_intra and got.min_inter == want.min_inter
    assert (got.proxy_labels < 0).any()  # class 6 owns fewer than 4 proxies


def test_lr_schedule_microbatch_slots_and_pcg64_codec_equal_jax():
    for n in (1, 10, 250, 300):
        np.testing.assert_array_equal(port_trainer.lr_schedule_values(3.5e-4, n),
                                      jax_trainer.lr_schedule_values(3.5e-4, n))
    for batch, n, paired in [(24, 6, False), (16, 2, True), (384, 4, True), (12, 3, False)]:
        np.testing.assert_array_equal(port_trainer.microbatch_slots(batch, n, paired),
                                      jax_trainer.microbatch_slots(batch, n, paired))
    with pytest.raises(ValueError, match="pair count"):
        port_trainer.microbatch_slots(20, 4, True)
    gen = np.random.default_rng(123)
    gen.standard_normal(17)  # leave a buffered uint32
    gen.integers(0, 10, size=3)
    code = port_trainer._encode_pcg64(gen)
    np.testing.assert_array_equal(code, jax_trainer._encode_pcg64(gen))
    clone = port_trainer._decode_pcg64(code)
    assert np.array_equal(clone.integers(0, 1 << 62, size=8), gen.integers(0, 1 << 62, size=8))


# ---------------------------------------------------------------- BN and ResNet
def test_batchnorm_train_mode_and_running_update_match_flax():
    rng = np.random.default_rng(1)
    x = rng.normal(1.0, 2.0, size=(6, 5, 4, 3)).astype(np.float32)  # NHWC for flax
    mean0 = rng.normal(size=5).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, size=5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=5).astype(np.float32)
    bias = rng.normal(size=5).astype(np.float32)
    flax_bn = FlaxBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, upd = flax_bn.apply(variables, jnp.asarray(x).transpose(0, 2, 3, 1),
                              mutable=["batch_stats"])
    bn = TorchBatchNorm(5).train()
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0),
                        "running_var": torch.from_numpy(var0)})
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), upd["batch_stats"]["mean"], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), upd["batch_stats"]["var"], atol=1e-5)
    # a bf16 input: bf16 out, the statistics and the running buffers stay f32
    y = bn(torch.from_numpy(x).bfloat16())
    assert y.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    # eval mode reads the running statistics and leaves them alone
    before = bn.running_var.clone()
    bn.eval()(torch.from_numpy(x))
    assert torch.equal(bn.running_var, before)


def test_resnet_train_mode_output_and_stats_match_flax(flax_variables):
    module, variables = flax_variables
    x = np.random.default_rng(2).normal(size=(8, *IMG, 3)).astype(np.float32)
    want, upd = jax.jit(lambda v, x: module.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    model = ResNet50ReID(stage_sizes=STAGES).train()
    model.load_state_dict(variables_from_jax("resnet50", variables), strict=True)
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = np.asarray(want)
    assert np.abs(got.detach().numpy() - want).max() <= 1e-4 * np.abs(want).max()
    sd_want = variables_from_jax("resnet50", {"params": variables["params"],
                                  "batch_stats": jax.device_get(upd["batch_stats"])})
    running = [k for k in sd_want if "running" in k]
    assert _max_err(model.state_dict(), sd_want, running) <= 1e-5


# ---------------------------------------------------------------- lockstep
def _step_inputs(seed=0):
    """A pre-augmented paired batch of 16 with a padded pair, centers and a
    proxy table whose classes own 3, 2, 1 and 3 of 3 slots (-1 padding)."""
    rng = np.random.default_rng(seed)
    b = P_ * K_ * 2  # 16
    u8 = rng.integers(0, 256, (b, *IMG, 3), dtype=np.uint8)
    scal = draw_scalars(b, *IMG, 10, 0.4, 0.3, 0.4, (0.05, 0.30), (0.3, 3.3),
                        torch.Generator().manual_seed(seed))
    images = fused_augment_plain(torch.from_numpy(u8), scal, 10, torch.float32)
    labels = np.repeat(np.arange(4), 4).astype(np.int32)
    dist = np.stack([np.zeros(b // 2), rng.integers(1, 6, b // 2)], 1).reshape(-1)
    mask = np.ones(b, bool)
    mask[6:8] = False
    unit = lambda a: (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)
    centers, proxies = unit(rng.normal(size=(4, 2048))), unit(rng.normal(size=(12, 2048)))
    plabels = np.asarray([0, 0, 0, 1, 1, -1, 2, -1, -1, 3, 3, 3], np.int32)
    return images, labels, dist.astype(np.int32), mask, centers, proxies, plabels


def test_one_step_lockstep_with_the_jax_train_step(synth, flax_variables, jax_side):
    _, variables = flax_variables
    images, labels, dist, mask, centers, proxies, plabels = _step_inputs()
    jtr = jax_side()
    new, metrics = jtr._train_step(
        jtr.state, images.permute(0, 2, 3, 1).contiguous().numpy(), labels, dist, mask,
        np.zeros(len(labels), np.int32), centers, proxies, plabels, jnp.float32(1),
        jax.random.key(0))
    new, metrics = jax.device_get((new, metrics))

    tr = _port_trainer(synth, variables)
    tr.set_epoch_hyperparams(1)
    t = torch.from_numpy
    m = tr.forward_backward(images, t(labels).long(), t(dist).long(), t(mask), t(centers),
                            t(proxies), t(plabels).long(), 1)
    weights_sum = tr.apply_update()
    got = dict(zip(port_trainer.METRICS, [*m.tolist(), weights_sum.item()]))
    for name in ("loss", "center_loss", "proxy_loss", "batch_acc_bal", "avg_max_prob",
                 "weights_sum"):
        assert got[name] == pytest.approx(float(metrics[name]), rel=1e-4), name

    names = dict(tr.online.named_parameters())
    mu, nu = _adam_moments(new.opt_state)
    state = tr.optimizer.state
    assert max(float((state[names[k]]["exp_avg"] - mu[k]).abs().max()) for k in mu) <= 1e-5
    assert max(float((state[names[k]]["exp_avg_sq"] - nu[k]).abs().max()) for k in nu) <= 1e-5
    online = variables_from_jax("resnet50", {"params": new.params, "batch_stats": new.batch_stats})
    ema = variables_from_jax("resnet50", {"params": new.momentum_params,
                              "batch_stats": new.momentum_batch_stats})
    port_online, port_ema = tr.online.state_dict(), tr.momentum.state_dict()
    running = [k for k in online if "running" in k]
    assert _max_err(port_online, online, running) <= 1e-5
    assert _max_err(port_ema, ema, running) <= 1e-6
    excluded = total = 0
    for k in mu:
        keep = mu[k].abs() > 1e-7  # effective gradient above 1e-6
        excluded += int((~keep).sum())
        total += keep.numel()
        if keep.any():
            assert float((port_online[k] - online[k]).abs()[keep].max()) <= 1e-5, k
            assert float((port_ema[k] - ema[k]).abs()[keep].max()) <= 1e-6, k
    assert excluded < 0.05 * total, (excluded, total)


def test_one_epoch_lockstep_with_the_jax_trainer(synth, flax_variables, jax_side, monkeypatch):
    """Mining plus every PK batch of one epoch on both sides. The JAX
    trainer's augmentation is interpret-mode K1 on the scalar tables the
    port draws; both decode the same JPEGs through PIL."""
    from daliid_tpu.data import native_loader
    from daliid_tpu_torch.data import native_loader as port_native_loader

    _, variables = flax_variables
    monkeypatch.setattr(native_loader, "native_loader_available", lambda: False)
    monkeypatch.setattr(port_native_loader, "native_loader_available", lambda: False)
    tables = []
    drawn = train_augment_mod.draw_scalars

    def recording(*args, **kw):
        tables.append(drawn(*args, **kw))
        return tables[-1]

    monkeypatch.setattr(train_augment_mod, "draw_scalars", recording)
    tr = _port_trainer(synth, variables)
    got = tr.train_epoch(1)
    assert len(tables) == tr.sampler.batches_per_epoch() == 2

    jtr = jax_side()
    first = next(iter(PKBatchSampler(tr.sampler.table, tr.sampler.labels, P=P_, K=K_,
                                     kind_of_transform=1, turbulence_dir=tr.sampler.turbulence_dir,
                                     seed=TRAIN_KW["seed"]).epoch()))
    np.testing.assert_array_equal(tr._decode_batch(first.paths), jtr._decode_batch(first.paths))
    queue = list(tables)
    jtr._augment = lambda images_u8, key: _augment_core(
        jnp.asarray(np.asarray(images_u8)), jnp.asarray(queue.pop(0).numpy()), 10,
        jnp.float32, interpret=True)
    want = jtr.train_epoch(1)
    assert not queue
    for name in ("loss", "center_loss", "proxy_loss"):
        assert got[name] == pytest.approx(want[name], rel=1e-3), name
    params = params_from_jax("resnet50", jax.device_get(jtr.state.params))
    port = tr.online.state_dict()
    diffs = torch.cat([(port[k] - params[k]).abs().flatten() for k in params])
    assert float(diffs.max()) <= 2 * TRAIN_KW["base_lr"] * len(tables)
    assert float((diffs <= 1e-4).float().mean()) >= 0.95


# ---------------------------------------------------------------- port only
class _TinyLN(nn.Module):
    """BN-free embedding model: grad-accum equals the full batch only
    without BatchNorm (BN statistics are per microbatch)."""

    dtype = torch.float32

    def __init__(self):
        super().__init__()
        self.proj = nn.Linear(3, 16)
        self.ln = nn.LayerNorm(16)

    def forward(self, x):
        return self.ln(self.proj(x.float().mean(dim=(2, 3))))


@pytest.mark.parametrize("grad_accum", [2, 3])
def test_grad_accum_matches_full_batch(synth, grad_accum):
    """``--grad_accum`` reproduces the full-batch gradient when the loss
    weights are uniform (clean batches) and nothing is padded (K = 3 = the
    images per identity): the same loss and Adam moments within f32
    reassociation (mirrors tests/test_train.py:387)."""
    table, _ = synth

    def make(ga):
        torch.manual_seed(0)
        model = _TinyLN()
        online = ModelBundle(module=model, feature_dim=16, name="tinyln")
        momentum = ModelBundle(module=copy.deepcopy(model), feature_dim=16, name="tinyln")
        sampler = PKBatchSampler(table, table.pids, P=4, K=3, kind_of_transform=0, seed=0)
        return port_trainer.Trainer(online, momentum, sampler, img_size=IMG, num_epochs=4,
                                    base_lr=1e-3, compute_dtype=torch.float32,
                                    extractor_batch=16, seed=12, grad_accum=ga,
                                    decode_workers=2)

    full, accum = make(1), make(grad_accum)
    m1, m3 = full.train_epoch(1), accum.train_epoch(1)
    for name in ("loss", "center_loss", "proxy_loss"):
        assert m3[name] == pytest.approx(m1[name], rel=1e-5), name
    for p1, p3 in zip(full.online.parameters(), accum.online.parameters()):
        s1, s3 = full.optimizer.state[p1], accum.optimizer.state[p3]
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(s3[key].numpy(), s1[key].numpy(), rtol=5e-4, atol=1e-7)


def test_resume_is_bit_equal_to_an_uninterrupted_run(synth, flax_variables, tmp_path):
    """Two epochs in a row equal one epoch, a checkpoint, a fresh trainer
    restored from it and one more epoch, bit for bit: weights, EMA, BN
    statistics, Adam state and the RNG streams (mirrors
    tests/test_checkpoint.py:138)."""
    _, variables = flax_variables
    continuous = _port_trainer(synth, variables)
    cont = [continuous.train_epoch(e)["loss"] for e in (1, 2)]

    first = _port_trainer(synth, variables)
    assert first.train_epoch(1)["loss"] == cont[0]
    mgr = ckpt_mod.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, first.state_dict(), metrics={"rank1": 0.5}, rng=first.rng_state())

    resumed = _port_trainer(synth, variables)
    state, epoch, rng = ckpt_mod.CheckpointManager(str(tmp_path / "ckpt")).restore()
    assert epoch == 1 and rng is not None
    resumed.load_state_dict(state)
    resumed.set_rng_state(rng)
    assert resumed.train_epoch(2)["loss"] == cont[1]
    for a, b in ((continuous.online, resumed.online), (continuous.momentum, resumed.momentum)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    s_a, s_b = continuous.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i, st in s_a["state"].items():
        for key, v in st.items():
            assert torch.equal(v, s_b["state"][i][key]), (i, key)
    for k, v in continuous.rng_state().items():
        np.testing.assert_array_equal(v, resumed.rng_state()[k])


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the int8 CPU path's many small ops: beside
    the other workers of a parallel test run, OpenMP's eight threads a
    worker oversubscribe the cores and an int8 CLI run takes minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_int8_mining_extractor_matches_the_jax_one(synth, flax_variables, monkeypatch,
                                                   one_torch_thread):
    """``mining_quantize='int8'``: a separate extractor on its own copy of the
    model (validation keeps the float32 one) re-embeds the train table like
    the JAX package's int8 extractor on the same weights (cosine > 0.9999:
    the int8 embeddings of the two packages differ within float32 summation
    order, which a quantize can follow by one step), and the next epoch's
    weights drop its scales."""
    import daliid_tpu.data.native_loader as jax_native
    import daliid_tpu_torch.data.native_loader as port_native
    from daliid_tpu.eval.features import FeatureExtractor as JaxExtractor

    monkeypatch.setattr(jax_native, "native_loader_available", lambda: False)
    monkeypatch.setattr(port_native, "native_loader_available", lambda: False)
    module, variables = flax_variables
    tr = _port_trainer(synth, variables, mining_quantize="int8", mining_calib_batches=2)
    mining = tr._mining_extractor
    assert tr.extractor.quantize is None and mining.quantize == "int8"
    assert mining.bundle.module is not tr.extractor.bundle.module
    tr.mine_proxies()
    assert mining._calib_final and tr.extractor.quant_scales is None
    got = mining.extract(tr.sampler.table)
    want = JaxExtractor(JaxBundle(module=module, variables=variables, feature_dim=2048,
                                  name="tiny"), img_size=IMG, batch_size=16, quantize="int8",
                        calib_batches=2).extract([str(p) for p in tr.sampler.table.paths])
    cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
    assert got.shape == want.shape and cos.min() > 0.9999
    tr.train_epoch(1)  # mines again with the new weights: the scales are recalibrated
    assert mining._calib_final and mining.quant_scales is not None


def test_train_cli_mining_quantize_int8_keeps_validation_in_float(tmp_path, monkeypatch,
                                                                 one_torch_thread):
    """``train --mining_quantize int8 --mining_calib_batches 2`` for two tiny
    epochs with validation each epoch: every calibration is the mining
    extractor's, once an epoch (its scales dropped by the new weights), and
    no validation forward runs an int8 layer."""
    from daliid_tpu_torch.cli import train
    from daliid_tpu_torch.eval.features import FeatureExtractor
    from daliid_tpu_torch.ops import quantize as q8

    monkeypatch.setitem(port_factory.MODEL_REGISTRY, "resnet50",
                        lambda dtype=torch.float32, **kw: (
                            ResNet50ReID(stage_sizes=STAGES, dtype=dtype), 2048))
    finals, planned = [], []
    finalize = FeatureExtractor._finalize_calibration
    quantized = q8.quantized

    def spy_finalize(self):
        finals.append(self)
        return finalize(self)

    def spy_quantized(module, plan):
        planned.append(len(plan))
        return quantized(module, plan)

    monkeypatch.setattr(FeatureExtractor, "_finalize_calibration", spy_finalize)
    monkeypatch.setattr(q8, "quantized", spy_quantized)
    # 4 identities x 2 train images: one paired step an epoch
    make_synthetic_dataset(str(tmp_path / "data" / "Synthetic"), num_ids=4, imgs_per_id_train=2,
                           imgs_per_id_test=2, height=IMG[0], width=IMG[1])
    args = train.build_argparser().parse_args(
        ["--device", "cpu", "--dataset", "Synthetic", "--data_root", str(tmp_path / "data"),
         "--img_height", str(IMG[0]), "--img_width", str(IMG[1]), "--P", "4", "--K", "2",
         "--epochs", "2", "--eval_freq", "1", "--compute_dtype", "float32",
         "--extractor_batch", "16", "--mining_quantize", "int8", "--mining_calib_batches", "2",
         "--skip_initial_eval", "--path_to_save_models", str(tmp_path / "ckpt"),
         "--path_to_save_metrics", str(tmp_path / "metrics")])
    train.main(args)
    assert len(finals) == 2 and all(e.quantize == "int8" for e in finals)
    assert finals[0] is finals[1]
    # mining forwards run 17 int8 layers; every validation forward none
    assert planned.count(17) > 0 and planned.count(0) > 0
    assert set(planned) == {0, 17}
    import json

    progress = json.loads((tmp_path / "metrics" / "progress_resnet50_v0.json").read_text())
    assert [p["epoch"] for p in progress] == [1, 2]
    assert all(np.isfinite(p["loss"]) for p in progress)


def test_checkpoint_manager_keeps_the_best_or_the_newest(tmp_path):
    state = {"w": torch.arange(3.0)}
    best = ckpt_mod.CheckpointManager(str(tmp_path / "best"), max_to_keep=2)
    for epoch, r1 in ((1, 0.4), (2, 0.9), (3, 0.6), (4, 0.5)):
        best.save(epoch, state, metrics={"rank1": r1})
    assert best.best_step() == 2 and best.latest_step() == 3
    assert sorted(p.name for p in (tmp_path / "best").glob("*.pt")) == ["2.pt", "3.pt"]
    latest = ckpt_mod.CheckpointManager(str(tmp_path / "latest"), max_to_keep=1,
                                        track_best=False)
    for epoch in (1, 2):
        latest.save(epoch, state)
    assert [p.name for p in (tmp_path / "latest").glob("*.pt")] == ["2.pt"]
    again = ckpt_mod.CheckpointManager(str(tmp_path / "best"))  # reads the index back
    assert again.metrics(2) == {"rank1": 0.9} and again.restore()[1] == 3
    with pytest.raises(FileNotFoundError):
        ckpt_mod.CheckpointManager(str(tmp_path / "empty")).restore()


def test_saved_weights_reload_through_load_state(synth, flax_variables, tmp_path):
    """A ``model_online_*`` file written after training reloads through the
    port's ``load_state`` into a fresh model with the same embeddings."""
    from daliid_tpu_torch.augment.preprocess import normalize_images

    _, variables = flax_variables
    tr = _port_trainer(synth, variables)
    tr.train_epoch(1)
    path = str(tmp_path / "model_online_tiny_v0.pt")
    ckpt_mod.save_weights(path, tr.online.state_dict())
    fresh = ResNet50ReID(stage_sizes=STAGES).eval()
    fresh.load_state_dict(load_state("resnet50", path), strict=True)
    x = normalize_images(torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (4, *IMG, 3), dtype=np.uint8)))
    with torch.inference_mode():
        assert torch.equal(fresh(x), tr.online.eval()(x))


def test_train_cli_on_the_cpu_trains_validates_and_checkpoints(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ckpt, metrics = tmp_path / "ckpt", tmp_path / "metrics"
    r = subprocess.run(
        [sys.executable, "-m", "daliid_tpu_torch", "train", "--device", "cpu",
         "--dataset", "Synthetic", "--data_root", str(tmp_path / "data"),
         "--img_height", str(IMG[0]), "--img_width", str(IMG[1]), "--P", "4", "--K", "2",
         "--epochs", "2", "--eval_freq", "1", "--compute_dtype", "float32",
         "--extractor_batch", "64", "--path_to_save_models", str(ckpt),
         "--path_to_save_metrics", str(metrics)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "Iteration number 2/2" in r.stdout and "Rank-1" in r.stdout
    import json

    progress = json.loads((metrics / "progress_resnet50_v0.json").read_text())
    assert [p["epoch"] for p in progress] == [1, 2]
    assert all(np.isfinite(p["loss"]) and 0.0 <= p["rank1"] <= 1.0 for p in progress)
    assert (ckpt / "latest" / "2.pt").exists() and any(ckpt.glob("*.pt"))
    weights = load_state("resnet50", str(ckpt / "model_online_resnet50_v0.pt"))
    ResNet50ReID().load_state_dict(weights, strict=True)


def test_train_cli_rejects_unported_flags(tmp_path):
    from daliid_tpu_torch.cli import train

    # every flag is ported (the head and SIE refusals: test_torch_train_vit.py);
    # --remat is refused for a CNN, as the JAX CLI refuses it
    args = train.build_argparser().parse_args(["--dataset", "Synthetic", "--remat", "full"])
    with pytest.raises(SystemExit, match="only applies to the transformer family"):
        train.main(args)
    # the fault-injection and multi-process flags are ported
    # (tests/test_torch_distributed.py): --multihost without the gang's address
    # is refused before any work
    args = train.build_argparser().parse_args(["--dataset", "Synthetic", "--multihost"])
    with pytest.raises(SystemExit, match="--multihost needs --coordinator_address"):
        train.main(args)
    args = train.build_argparser().parse_args(
        ["--dataset", "Synthetic", "--data_root", str(tmp_path), "--device", "cpu",
         "--model_name", "vit_base"])
    with pytest.raises(KeyError, match="not yet ported"):
        train.main(args)
    assert not (tmp_path / "Synthetic").exists()  # refused before any data work


# ---------------------------------------------------------------- densenet121's classifier head
DENSE_IMG = (64, 32)
TINY_DENSE = dict(block_sizes=(1, 1, 1, 1), growth=8)
DENSE_DIM = 46  # 2 x the 23 channels of the last block


@pytest.fixture
def tiny_densenet(monkeypatch):
    monkeypatch.setitem(jax_factory.MODEL_REGISTRY, "densenet121",
                        lambda dtype=jnp.float32, num_classes=0, **kw: (
                            flax_densenet.DenseNet121ReID(**TINY_DENSE, num_classes=num_classes,
                                                          dtype=dtype), DENSE_DIM))
    monkeypatch.setitem(port_factory.MODEL_REGISTRY, "densenet121",
                        lambda dtype=torch.float32, num_classes=0, **kw: (
                            DenseNet121ReID(**TINY_DENSE, num_classes=num_classes, dtype=dtype),
                            DENSE_DIM))


def _dense_step_inputs(seed=0):
    rng = np.random.default_rng(seed)
    b = 16
    u8 = rng.integers(0, 256, (b, *DENSE_IMG, 3), dtype=np.uint8)
    scal = draw_scalars(b, *DENSE_IMG, 10, 0.4, 0.3, 0.4, (0.05, 0.30), (0.3, 3.3),
                        torch.Generator().manual_seed(seed))
    images = fused_augment_plain(torch.from_numpy(u8), scal, 10, torch.float32)
    labels = np.repeat(np.arange(4), 4).astype(np.int32)
    dist = np.stack([np.zeros(b // 2), rng.integers(1, 6, b // 2)], 1).reshape(-1)
    mask = np.ones(b, bool)
    mask[6:8] = False
    unit = lambda a: (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)
    centers = unit(rng.normal(size=(4, DENSE_DIM)))
    proxies = unit(rng.normal(size=(12, DENSE_DIM)))
    plabels = np.asarray([0, 0, 0, 1, 1, -1, 2, -1, -1, 3, 3, 3], np.int32)
    return images, labels, dist.astype(np.int32), mask, centers, proxies, plabels


def test_densenet_classifier_one_step_lockstep_with_the_jax_train_step(tiny_densenet, synth):
    table, turb = synth
    module, dim = jax_factory.MODEL_REGISTRY["densenet121"](num_classes=4)
    init = jax.jit(lambda key, x: module.init(key, x, train=True))
    variables = jax.tree.map(np.asarray, init(jax.random.key(0), jnp.zeros((1, *DENSE_IMG, 3))))
    assert "classifier" in variables["params"]
    kw = {**TRAIN_KW, "img_size": DENSE_IMG}
    jt = JaxTable(table.paths, table.pids, table.camids, table.kinds, "Synthetic")
    jtr = jax_trainer.Trainer(
        JaxBundle(module=module, variables=variables, feature_dim=dim, name="densenet121"),
        JaxBundle(module=module, variables=jax.tree.map(np.copy, variables), feature_dim=dim,
                  name="densenet121"),
        JaxSampler(jt, jt.pids, P=P_, K=K_, kind_of_transform=1, turbulence_dir=turb, seed=5),
        compute_dtype=jnp.float32, **kw)
    images, labels, dist, mask, centers, proxies, plabels = _dense_step_inputs()
    new, metrics = jax.device_get(jtr._train_step(
        jtr.state, images.permute(0, 2, 3, 1).contiguous().numpy(), labels, dist, mask,
        np.zeros(len(labels), np.int32), centers, proxies, plabels, jnp.float32(1),
        jax.random.key(0)))

    online, momentum = port_factory.build_model_pair("densenet121", img_size=DENSE_IMG,
                                                     num_classes=4)
    online.module.load_state_dict(variables_from_jax("densenet121", variables), strict=True)
    momentum.module.load_state_dict(online.module.state_dict(), strict=True)
    tr = port_trainer.Trainer(online, momentum,
                              PKBatchSampler(table, table.pids, P=P_, K=K_, kind_of_transform=1,
                                             turbulence_dir=turb, seed=5),
                              compute_dtype=torch.float32, decode_workers=2, **kw)
    tr.set_epoch_hyperparams(1)
    t = torch.from_numpy
    m = tr.forward_backward(images, t(labels).long(), t(dist).long(), t(mask), t(centers),
                            t(proxies), t(plabels).long(), 1)
    weights_sum = tr.apply_update()
    got = dict(zip(port_trainer.METRICS, [*m.tolist(), weights_sum.item()]))
    for name in port_trainer.METRICS:
        assert got[name] == pytest.approx(float(metrics[name]), rel=1e-5), name

    names = dict(tr.online.named_parameters())
    found = [s for s in jax.tree_util.tree_leaves(
        new.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    assert len(found) == 1
    mu = params_from_jax("densenet121", found[0].mu)
    nu = params_from_jax("densenet121", found[0].nu)
    assert mu.keys() == names.keys() and "classification.weight" in mu
    state = tr.optimizer.state
    assert max(float((state[names[k]]["exp_avg"] - mu[k]).abs().max()) for k in mu) <= 1e-5
    assert max(float((state[names[k]]["exp_avg_sq"] - nu[k]).abs().max()) for k in nu) <= 1e-5
    online_w = variables_from_jax("densenet121", {"params": new.params,
                                                  "batch_stats": new.batch_stats})
    port_online = tr.online.state_dict()
    running = [k for k in online_w if "running" in k]
    assert _max_err(port_online, online_w, running) <= 1e-5
    excluded = total = 0
    for k in mu:
        keep = mu[k].abs() > 1e-7  # effective gradient above 1e-6
        excluded += int((~keep).sum())
        total += keep.numel()
        if keep.any():
            assert float((port_online[k] - online_w[k]).abs()[keep].max()) <= 1e-5, k
    assert excluded < 0.05 * total, (excluded, total)


class _TwoHeads(nn.Module):
    """A stub whose train-mode output is JPM's ``([scores], [feats])`` or
    a classifier model's ``(embedding, logits)``."""

    def __init__(self, jpm: bool):
        super().__init__()
        self.jpm = jpm
        self.proj = nn.Linear(3, 8)
        self.cls = nn.Linear(8, 4, bias=False)

    def forward(self, x):
        h = self.proj(x.mean(dim=(2, 3)))
        logits = self.cls(h)
        if self.training and self.jpm:
            return [logits, 0.5 * logits], [h, 2.0 * h]
        return (h, logits) if self.training else h


@pytest.mark.parametrize("jpm", [True, False])
def test_trainer_tells_jpm_and_classifier_outputs_apart(synth, monkeypatch, jpm):
    """JPM's output still takes the JPM losses; an (embedding, logits)
    pair takes the cross entropy on the logits, added to center + proxy."""
    table, turb = synth
    model = _TwoHeads(jpm)
    tr = port_trainer.Trainer(
        ModelBundle(module=model, feature_dim=8, name="stub"),
        ModelBundle(module=copy.deepcopy(model), feature_dim=8, name="stub"),
        PKBatchSampler(table, table.pids, P=P_, K=K_, kind_of_transform=1,
                       turbulence_dir=turb, seed=5),
        compute_dtype=torch.float32, decode_workers=2, **TRAIN_KW)
    calls = []
    jpm_losses = tr._jpm_losses
    monkeypatch.setattr(tr, "_jpm_losses", lambda *a: calls.append(a) or jpm_losses(*a))
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.normal(size=(16, 3, *IMG)).astype(np.float32))
    labels = torch.from_numpy(np.repeat(np.arange(4), 4))
    dist = torch.zeros(16, dtype=torch.long)
    mask = torch.ones(16, dtype=torch.bool)
    unit = lambda a: torch.from_numpy((a / np.linalg.norm(a, axis=1, keepdims=True)).astype(
        np.float32))
    dim = 16 if jpm else 8  # JPM's concat([global, local / 4])
    centers, proxies = unit(rng.normal(size=(4, dim))), unit(rng.normal(size=(8, dim)))
    plabels = torch.from_numpy(np.repeat(np.arange(4), 2))
    tr.lambda_distortion = 0.0
    total = tr._losses(images, labels, dist, mask, torch.zeros_like(labels), centers, proxies,
                       plabels, 1)[0]
    assert len(calls) == int(jpm)
    if not jpm:
        h, logits = model(images)
        fvs = h / (torch.linalg.vector_norm(h, dim=1, keepdim=True) + 1e-9)
        want = (port_losses.weighted_center_loss(fvs, labels, dist, centers, 1, 4, tau=0.05,
                                                 sample_mask=mask)[0]
                + 0.4 * port_losses.weighted_proxy_loss(fvs, labels, dist, proxies, plabels, 1,
                                                        4, tau=0.05, sample_mask=mask, p_max=3)
                + port_losses.weighted_cross_entropy_loss(torch.softmax(logits, dim=-1), labels,
                                                          dist, 1, 4, sample_mask=mask)[0])
        assert total.item() == pytest.approx(want.item(), rel=1e-6)


def test_train_cli_trains_densenet121_with_its_classifier(tiny_densenet, tmp_path):
    """``train --model_name densenet121 --num_classes -1``: one class per
    training identity, finite losses, validation, and a checkpoint whose
    head the evaluate path (built with ``num_classes=0``) leaves unread."""
    import json

    from daliid_tpu_torch.cli import train

    make_synthetic_dataset(str(tmp_path / "data" / "Synthetic"), num_ids=4, imgs_per_id_train=3,
                           imgs_per_id_test=2, height=DENSE_IMG[0], width=DENSE_IMG[1])
    ckpt, metrics = tmp_path / "ckpt", tmp_path / "metrics"
    train.main(train.build_argparser().parse_args(
        ["--device", "cpu", "--dataset", "Synthetic", "--data_root", str(tmp_path / "data"),
         "--model_name", "densenet121", "--num_classes", "-1",
         "--img_height", str(DENSE_IMG[0]), "--img_width", str(DENSE_IMG[1]), "--P", "4",
         "--K", "2", "--epochs", "1", "--eval_freq", "1", "--compute_dtype", "float32",
         "--extractor_batch", "32", "--path_to_save_models", str(ckpt),
         "--path_to_save_metrics", str(metrics)]))
    progress = json.loads((metrics / "progress_densenet121_v0.json").read_text())
    assert len(progress) == 1 and np.isfinite(progress[0]["loss"])
    assert 0.0 <= progress[0]["rank1"] <= 1.0
    saved = load_state("densenet121", str(ckpt / "model_online_densenet121_v0.pt"))
    assert saved["classification.weight"].shape == (4, DENSE_DIM)
    plain = DenseNet121ReID(**TINY_DENSE)
    plain.load_state_dict(load_state("densenet121", str(ckpt / "model_online_densenet121_v0.pt"),
                                     plain), strict=True)
