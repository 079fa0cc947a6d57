"""The transformer training path of the PyTorch port against the JAX package,
on the CPU: the JPM train step in lockstep with the JAX ``Trainer``, and the
train and evaluate CLIs on ``--device cpu`` with their refusals.

A tiny TransReID-JPM (embed 32, 2 heads, depth 2, 8x8 patches at stride 6
on 32x16 images, SIE over 4 cameras, drop-path 0: JAX's drop-path key
cannot be replayed in torch) is registered as ``transreid_jpm`` in both
packages' registries, so the factories and the CLIs' checks see the real
name. The JAX trainer runs on the tests' 8-device CPU mesh, so the batch is
16 slots and nothing is padded to the mesh.

Tolerances, as in ``tests/test_torch_train.py`` and for its reasons: the
step's losses and diagnostics within rtol 1e-4; Adam moments within
1e-5 (1 + their largest magnitude) and BN running statistics within atol
1e-5 (under a margin head the classifier's gradient reaches 270, about
1/|w| with the weights at std 0.001, and its moments agree to 1.6e-6
relative); parameters after the step within
1e-5 (= lr / 100) and the EMA within 1e-6 where the effective gradient
exceeds 1e-6 (|mu| > 1e-7), the elements left out fewer than 5%.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daliid_tpu.models.factory as jax_factory
import daliid_tpu_torch.models.factory as port_factory
from daliid_tpu.data.registry import ReidTable as JaxTable
from daliid_tpu.models.transreid_jpm import TransReIDJPM as FlaxJPM
from daliid_tpu.train import trainer as jax_trainer
from daliid_tpu.train.sampler import PKBatchSampler as JaxSampler
from daliid_tpu_torch.cli import evaluate as port_evaluate
from daliid_tpu_torch.cli import train as port_train
from daliid_tpu_torch.data import make_synthetic_dataset
from daliid_tpu_torch.models.torch_port import load_state, params_from_jax, variables_from_jax
from daliid_tpu_torch.models.transreid_jpm import TransReIDJPM
from daliid_tpu_torch.ops.fused_augment import draw_scalars, fused_augment_plain
from daliid_tpu_torch.train import trainer as port_trainer
from daliid_tpu_torch.train.sampler import PKBatchSampler

IMG = (32, 16)
TINY = dict(patch_size=8, patch_stride=6, embed_dim=32, depth=2, num_heads=2,
            drop_path_rate=0.0)
DIM = 5 * 32
TRAIN_KW = dict(img_size=IMG, base_lr=1e-3, weight_decay=5e-4, tau=0.05, beta=0.9,
                lambda_proxy=0.4, lambda_distortion=0.5, num_epochs=4, num_proxies=3, seed=5,
                extractor_batch=16)
_HEAD_KW = ("sie_cameras", "sie_coef", "num_classes", "id_loss_type", "margin_s", "margin_m")


def _tiny_flax(dtype=jnp.float32, img_size=IMG, **kw):
    return FlaxJPM(img_size=tuple(img_size), dtype=dtype, **TINY,
                   **{k: v for k, v in kw.items() if k in _HEAD_KW}), DIM


def _tiny_port(dtype=torch.float32, img_size=IMG, use_fused_attention=False, **kw):
    return TransReIDJPM(img_size=tuple(img_size), dtype=dtype, **TINY,
                        use_fused_attention=use_fused_attention,
                        **{k: v for k, v in kw.items() if k in _HEAD_KW}), DIM


@pytest.fixture
def tiny_jpm(monkeypatch):
    monkeypatch.setitem(jax_factory.MODEL_REGISTRY, "transreid_jpm", _tiny_flax)
    monkeypatch.setitem(port_factory.MODEL_REGISTRY, "transreid_jpm", _tiny_port)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_vit")
    splits, turb = make_synthetic_dataset(str(root / "Synthetic"), num_ids=4,
                                          imgs_per_id_train=3, imgs_per_id_test=2,
                                          height=IMG[0], width=IMG[1])
    return root, splits["train"], turb


def _step_inputs(seed=0):
    """A K1-augmented paired batch of 16 (a padded pair), camera ids 1-3,
    unit centers and a proxy table whose classes own 3, 2, 1 and 3 slots."""
    rng = np.random.default_rng(seed)
    b = 16
    u8 = rng.integers(0, 256, (b, *IMG, 3), dtype=np.uint8)
    scal = draw_scalars(b, *IMG, 10, 0.4, 0.3, 0.4, (0.05, 0.30), (0.3, 3.3),
                        torch.Generator().manual_seed(seed))
    images = fused_augment_plain(torch.from_numpy(u8), scal, 10, torch.float32)
    labels = np.repeat(np.arange(4), 4).astype(np.int32)
    dist = np.stack([np.zeros(b // 2), rng.integers(1, 6, b // 2)], 1).reshape(-1)
    mask = np.ones(b, bool)
    mask[6:8] = False
    camids = np.repeat(rng.integers(1, 4, b // 2), 2).astype(np.int32)
    unit = lambda a: (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)
    centers, proxies = unit(rng.normal(size=(4, DIM))), unit(rng.normal(size=(12, DIM)))
    plabels = np.asarray([0, 0, 0, 1, 1, -1, 2, -1, -1, 3, 3, 3], np.int32)
    return images, labels, dist.astype(np.int32), mask, camids, centers, proxies, plabels


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
    return (params_from_jax("transreid_jpm", found[0].mu),
            params_from_jax("transreid_jpm", found[0].nu))


@pytest.mark.parametrize("id_loss_type", ["softmax", "arcface"])
def test_jpm_one_step_lockstep_with_the_jax_train_step(tiny_jpm, synth, id_loss_type):
    _, table, turb = synth
    head = dict(num_classes=4, sie_cameras=4, id_loss_type=id_loss_type)
    j_online, j_momentum = jax_factory.build_model_pair("transreid_jpm", jax.random.key(0),
                                                        img_size=IMG, **head)
    variables = jax.tree.map(np.asarray, j_online.variables)
    jt = JaxTable(table.paths, table.pids, table.camids, table.kinds, "Synthetic")
    jtr = jax_trainer.Trainer(
        j_online, j_momentum,
        JaxSampler(jt, jt.pids, P=2, K=4, kind_of_transform=1, turbulence_dir=turb, seed=5),
        compute_dtype=jnp.float32, **TRAIN_KW)
    images, labels, dist, mask, camids, centers, proxies, plabels = _step_inputs()
    new, metrics = jtr._train_step(
        jtr.state, images.permute(0, 2, 3, 1).contiguous().numpy(), labels, dist, mask, camids,
        centers, proxies, plabels, jnp.float32(1), jax.random.key(0))
    new, metrics = jax.device_get((new, metrics))

    online, momentum = port_factory.build_model_pair("transreid_jpm", img_size=IMG, **head)
    online.module.load_state_dict(variables_from_jax("transreid_jpm", variables), strict=True)
    momentum.module.load_state_dict(online.module.state_dict(), strict=True)
    sampler = PKBatchSampler(table, table.pids, P=2, K=4, kind_of_transform=1,
                             turbulence_dir=turb, seed=5)
    tr = port_trainer.Trainer(online, momentum, sampler, compute_dtype=torch.float32,
                              decode_workers=2, **TRAIN_KW)
    tr.set_epoch_hyperparams(1)
    t = torch.from_numpy
    m = tr.forward_backward(images, t(labels).long(), t(dist).long(), t(mask), t(centers),
                            t(proxies), t(plabels).long(), 1, camids=t(camids).long())
    weights_sum = tr.apply_update()
    got = dict(zip(port_trainer.METRICS, [*m.tolist(), weights_sum.item()]))
    for name in port_trainer.METRICS:
        assert got[name] == pytest.approx(float(metrics[name]), rel=1e-4), name

    names = dict(tr.online.named_parameters())
    mu, nu = _adam_moments(new.opt_state)
    state = tr.optimizer.state
    assert mu.keys() == names.keys()
    for k in mu:
        for got_m, want_m in ((state[names[k]]["exp_avg"], mu[k]),
                              (state[names[k]]["exp_avg_sq"], nu[k])):
            tol = 1e-5 * (1.0 + float(want_m.abs().max()))
            assert float((got_m - want_m).abs().max()) <= tol, k
    want_online = variables_from_jax("transreid_jpm", {"params": new.params,
                                                       "batch_stats": new.batch_stats})
    want_ema = variables_from_jax("transreid_jpm", {"params": new.momentum_params,
                                                    "batch_stats": new.momentum_batch_stats})
    port_online, port_ema = tr.online.state_dict(), tr.momentum.state_dict()
    for k in (k for k in want_online if "running" in k):
        assert float((port_online[k] - want_online[k]).abs().max()) <= 1e-5, k
        assert float((port_ema[k] - want_ema[k]).abs().max()) <= 1e-6, k
    excluded = total = 0
    for k in mu:
        keep = mu[k].abs() > 1e-7
        excluded += int((~keep).sum())
        total += keep.numel()
        if keep.any():
            assert float((port_online[k] - want_online[k]).abs()[keep].max()) <= 1e-5, k
            assert float((port_ema[k] - want_ema[k]).abs()[keep].max()) <= 1e-6, k
    assert excluded < 0.05 * total, (excluded, total)


def _train_args(root, tmp_path, *extra):
    return port_train.build_argparser().parse_args(
        ["--device", "cpu", "--dataset", "Synthetic", "--data_root", str(root),
         "--img_height", str(IMG[0]), "--img_width", str(IMG[1]), "--P", "4", "--K", "2",
         "--epochs", "1", "--eval_freq", "1", "--compute_dtype", "float32",
         "--extractor_batch", "32", "--path_to_save_models", str(tmp_path / "ckpt"),
         "--path_to_save_metrics", str(tmp_path / "metrics"), *extra])


@pytest.mark.parametrize("model,extra", [
    ("tiny_vit_smoke", []),
    ("transreid_jpm", ["--num_classes", "-1", "--sie_cameras", "-1"]),
    ("transreid_jpm", ["--num_classes", "-1", "--id_loss_type", "cosface",
                       "--cosine_scale", "16"]),
])
def test_train_cli_trains_transformers_on_the_cpu(tiny_jpm, synth, tmp_path, model, extra):
    root, _, _ = synth
    best_r1, best_epoch = port_train.main(
        _train_args(root, tmp_path, "--model_name", model, *extra))
    assert best_epoch in (0, 1) and 0.0 <= best_r1 <= 1.0
    progress = json.loads((tmp_path / "metrics" / f"progress_{model}_v0.json").read_text())
    assert len(progress) == 1 and np.isfinite(progress[0]["loss"])
    weights = tmp_path / "ckpt" / f"model_online_{model}_v0.pt"
    if weights.exists():  # written on a new best rank-1
        bundle = port_factory.get_model(model, img_size=IMG, num_classes=4,
                                        sie_cameras=4 if "--sie_cameras" in extra else 0)
        bundle.module.load_state_dict(load_state(model, str(weights), bundle.module),
                                      strict=True)


@pytest.mark.parametrize("model,extra,match", [
    ("transreid_jpm", ["--sie_cameras", "3"], "too small"),
    ("transreid_jpm", ["--id_loss_type", "arcface"], "needs a classifier head"),
    ("transreid_jpm", ["--num_classes", "-1", "--cosine_margin", "0.3"], "only apply with"),
    ("tiny_vit_smoke", ["--num_classes", "-1", "--id_loss_type", "circle"], "only supported by"),
    ("resnet50", ["--sie_cameras", "4"], "has no SIE embedding"),
    ("transreid_jpm", ["--sie_coef", "3.0"], "only takes effect"),
    ("transreid_jpm", ["--remat", "tuned"], "not yet ported"),
])
def test_train_cli_refuses_what_the_jax_cli_refuses(tiny_jpm, synth, tmp_path, model, extra,
                                                    match):
    root, _, _ = synth
    with pytest.raises(SystemExit, match=match):
        port_train.main(_train_args(root, tmp_path, "--model_name", model, *extra))


def test_evaluate_cli_runs_a_jpm_with_sie_and_refuses_bad_flags(tiny_jpm, synth):
    root, _, _ = synth
    base = ["--targets", "Synthetic", "--data_root", str(root), "--device", "cpu",
            "--img_height", str(IMG[0]), "--img_width", str(IMG[1]), "--batch_size", "32",
            "--compute_dtype", "float32"]
    parse = port_evaluate.build_argparser().parse_args
    cmc, mAP = port_evaluate.main(parse(base + ["--model_name", "transreid_jpm",
                                                "--sie_cameras", "4"]))["Synthetic"]
    assert cmc.shape == (50,) and 0.0 <= mAP <= 1.0
    for extra, match in ((["--model_name", "transreid_jpm", "--sie_cameras", "3"], "too small"),
                         (["--model_name", "resnet50", "--sie_cameras", "4"], "no SIE"),
                         (["--model_name", "resnet50", "--gelu_approx"], "has no GELU"),
                         (["--model_name", "vit", "--sie_coef", "2.0"], "only takes effect")):
        with pytest.raises(SystemExit, match=match):
            port_evaluate.main(parse(base + extra))
