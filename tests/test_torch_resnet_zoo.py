"""The ResNet family of the PyTorch port against its flax modules (CPU).

Each of ``resnet50Seg``, ``resnet50IBN``, ``resnet101IBN``,
``dualresnet50``, ``multipart_resnet50`` and ``multiview_resnet50`` is a
flax module whose variables (BN scales, biases and running statistics, the
IBN InstanceNorm affine and the gates' biases drawn anew from a numpy seed)
are carried into the port by ``variables_from_jax``. Both packages
normalize and embed one uint8 batch in eval mode.

Tolerances, each with its reason:

- f32 embeddings and feature maps: max |port - flax| <= 1e-4 of the largest
  entry (float32 summation order in the convolutions; measured about 1e-6
  at stage sizes (1, 1, 1, 1) and full depth on 64x32 and 31x23 inputs);
- the IBN block in bf16: within one bf16 ulp of flax's (both take f32
  statistics and round the f32 result once; the statistics' summation
  order can move a rounding);
- the ``resnet50IBN`` train step: as ``tests/test_torch_train.py``'s
  one-step lockstep (losses rtol 1e-4, Adam moments and BN running
  statistics atol 1e-5).
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from daliid_tpu.augment.preprocess import normalize_images as jax_normalize
from daliid_tpu.data.registry import ReidTable as JaxTable
from daliid_tpu.models import factory as jax_factory
from daliid_tpu.models import resnet as flax_resnet
from daliid_tpu.models.factory import ModelBundle as JaxBundle
from daliid_tpu.models.torch_port import variables_to_torch
from daliid_tpu.train import trainer as jax_trainer
from daliid_tpu.train.sampler import PKBatchSampler as JaxSampler
from daliid_tpu_torch.augment.preprocess import normalize_images
from daliid_tpu_torch.cli import serve as port_serve
from daliid_tpu_torch.cli import train as port_train
from daliid_tpu_torch.data import make_synthetic_dataset
from daliid_tpu_torch.eval.features import FeatureExtractor
from daliid_tpu_torch.models import factory as port_factory
from daliid_tpu_torch.models import resnet as port_resnet
from daliid_tpu_torch.models.factory import ModelBundle, get_model
from daliid_tpu_torch.models.torch_port import load_state, params_from_jax, variables_from_jax
from daliid_tpu_torch.ops.fused_augment import draw_scalars, fused_augment_plain
from daliid_tpu_torch.train import trainer as port_trainer
from daliid_tpu_torch.train.sampler import PKBatchSampler

STAGES = (1, 1, 1, 1)
# an odd input size whose trunk map has 2 rows (the multipart h < 3 branch)
ODD = (31, 23)
REL_TOL = 1e-4
# name → (flax class, port class, constructor keywords) at reduced depth
VARIANTS = {
    "resnet50Seg": (flax_resnet.ResNet50ReID, port_resnet.ResNet50ReID,
                    {"seg_attention": True}),
    "resnet50IBN": (flax_resnet.ResNet50ReID, port_resnet.ResNet50ReID, {"ibn": True}),
    "dualresnet50": (flax_resnet.DualResNet50ReID, port_resnet.DualResNet50ReID, {}),
    "multipart_resnet50": (flax_resnet.MultiPartResNet50ReID,
                           port_resnet.MultiPartResNet50ReID, {}),
    "multiview_resnet50": (flax_resnet.MultiViewResNet50ReID,
                           port_resnet.MultiViewResNet50ReID, {}),
}
_RANGES = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.1, 0.1), "var": (0.5, 2.0)}


def _randomized(variables, seed=3):
    """Every scale, bias and BN statistic drawn anew (uniform in
    ``_RANGES``); kernels as initialized."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {name: walk(leaf) if isinstance(leaf, dict)
                else rng.uniform(*_RANGES[name], leaf.shape).astype(np.float32)
                if name in _RANGES else np.asarray(leaf)
                for name, leaf in tree.items()}

    return walk(jax.tree.map(np.asarray, variables))


def _images(size, n=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *size, 3), dtype=np.uint8)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _assert_close(got, want):
    got, want = _as_tuple(got), _as_tuple(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= REL_TOL, err


def _pair(flax_cls, port_cls, kw, size):
    module = flax_cls(**kw)
    variables = _randomized(module.init(jax.random.key(12), jnp.zeros((1, *size, 3))))
    model = port_cls(**kw).eval()
    model.load_state_dict(variables_from_jax("resnet50", variables), strict=True)
    return module, variables, model


@pytest.mark.parametrize("name,size", [(name, (64, 32)) for name in sorted(VARIANTS)]
                         + [("resnet50IBN", ODD), ("multiview_resnet50", ODD)])
def test_variant_matches_flax(name, size):
    flax_cls, port_cls, kw = VARIANTS[name]
    module, variables, model = _pair(flax_cls, port_cls, {"stage_sizes": STAGES, **kw}, size)
    images = _images(size)
    want = module.apply(variables, jax_normalize(jnp.asarray(images)), train=False)
    with torch.inference_mode():
        got = model(normalize_images(torch.from_numpy(images)))
    _assert_close(got, want)


@pytest.mark.parametrize("name", ["resnet50Seg", "resnet50IBN", "resnet101IBN", "dualresnet50",
                                  "multipart_resnet50", "multiview_resnet50"])
def test_factory_full_depth_matches_flax(name):
    """The factory's own model (full depth, ResNet-101 for resnet101IBN)
    with the flax factory's variables."""
    size = (64, 32)
    module, feature_dim = jax_factory.MODEL_REGISTRY[name](dtype=jnp.float32)
    variables = _randomized(module.init(jax.random.key(12), jnp.zeros((1, *size, 3))))
    pb = get_model(name, img_size=size)
    pb.module.load_state_dict(variables_from_jax(name, variables), strict=True)
    assert pb.feature_dim == feature_dim
    images = _images(size)
    want = module.apply(variables, jax_normalize(jnp.asarray(images)), train=False)
    with torch.inference_mode():
        got = pb.module(normalize_images(torch.from_numpy(images)))
    _assert_close(got, want)


def test_seg_mask_and_feature_map_match_flax():
    """``seg_attention`` multiplies the trunk's map by the mask before the
    pooling; ``return_feature_map`` returns the map before the mask."""
    size = (64, 32)
    kw = {"stage_sizes": STAGES, "seg_attention": True, "return_feature_map": True}
    module, variables, model = _pair(flax_resnet.ResNet50ReID, port_resnet.ResNet50ReID, kw,
                                     size)
    images = _images(size)
    mask = np.random.default_rng(4).uniform(0, 1, (3, 4, 2, 1)).astype(np.float32)
    fmap_j, emb_j = module.apply(variables, jax_normalize(jnp.asarray(images)),
                                 seg_mask=jnp.asarray(mask), train=False)
    with torch.inference_mode():
        fmap_p, emb_p = model(normalize_images(torch.from_numpy(images)),
                              seg_mask=torch.from_numpy(mask).permute(0, 3, 1, 2))
    _assert_close((fmap_p.permute(0, 2, 3, 1).contiguous(), emb_p), (fmap_j, emb_j))
    with torch.inference_mode():
        unmasked = model(normalize_images(torch.from_numpy(images)))[1]
    assert not torch.allclose(unmasked, emb_p)


def test_multipart_bands_of_a_short_map_are_the_whole_map():
    """A feature map of fewer than 3 rows: every part head pools the whole
    map (flax's ``h < 3`` branch)."""
    size = ODD
    module, variables, model = _pair(flax_resnet.MultiPartResNet50ReID,
                                     port_resnet.MultiPartResNet50ReID,
                                     {"stage_sizes": STAGES}, size)
    images = _images(size)
    want = module.apply(variables, jax_normalize(jnp.asarray(images)), train=False)
    with torch.inference_mode():
        got = model(normalize_images(torch.from_numpy(images)))
    _assert_close(got, want)


@pytest.mark.parametrize("shape", [(4, 16, 8, 64), (2, 9, 5, 256)])
def test_ibn_block_in_bf16_matches_flax(shape):
    """flax's InstanceNorm computes its statistics in f32 with the fast
    variance whatever the dtype; the port's IBN block on a bf16
    channels_last input lands within one bf16 ulp of it, train-mode BN half
    included."""
    b, h, w, c = shape
    rng = np.random.default_rng(5)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    block = flax_resnet.IBN(dtype=jnp.bfloat16)
    variables = _randomized(block.init(jax.random.key(0), jnp.zeros(shape, jnp.bfloat16)))
    xb = jnp.asarray(x, jnp.bfloat16)
    port = port_resnet.IBN(c, dtype=torch.bfloat16)
    sd = {"IN.weight": variables["params"]["instance"]["scale"],
          "IN.bias": variables["params"]["instance"]["bias"],
          "BN.weight": variables["params"]["batch"]["scale"],
          "BN.bias": variables["params"]["batch"]["bias"],
          "BN.running_mean": variables["batch_stats"]["batch"]["mean"],
          "BN.running_var": variables["batch_stats"]["batch"]["var"]}
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    xt = xt.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    for train in (False, True):
        want = block.apply(variables, xb, train=train, mutable=["batch_stats"])[0]
        got = port.train(train)(xt)
        assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
        got = got.detach().float().permute(0, 2, 3, 1).numpy()
        want = np.asarray(want.astype(jnp.float32))
        _, e = np.frexp(np.abs(want))
        ulp = np.ldexp(1.0, e - 8)
        assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


def test_ibn_torch_checkpoint_round_trip(tmp_path):
    """The JAX package's reference-scheme export (``bn1.IN`` / ``bn1.BN``)
    saved with ``torch.save`` loads into the port as ``variables_from_jax``
    carries it, the wrapper's unused ImageNet ``fc`` head dropped."""
    module, _ = jax_factory.MODEL_REGISTRY["resnet50IBN"](dtype=jnp.float32)
    variables = _randomized(module.init(jax.random.key(12), jnp.zeros((1, 64, 32, 3))))
    exported = variables_to_torch("resnet50IBN", variables)
    assert "layer1.0.bn1.IN.weight" in exported and "layer4.0.bn1.weight" in exported
    sd = {k: torch.from_numpy(np.array(v)) for k, v in exported.items()}
    sd["fc.weight"] = torch.zeros(3, 2048)
    path = str(tmp_path / "ibn.pt")
    torch.save(sd, path)
    model = get_model("resnet50IBN", img_size=(64, 32)).module
    loaded = load_state("resnet50IBN", path, model)
    direct = variables_from_jax("resnet50IBN", variables)
    assert loaded.keys() == direct.keys() == model.state_dict().keys()
    for k in direct:
        assert torch.equal(loaded[k], direct[k]), k


@pytest.mark.parametrize("name,heads", [
    ("dualresnet50", "id_bn, bias_bn"), ("multipart_resnet50", "upper_bn, middle_bn, lower_bn"),
    ("multiview_resnet50", "spatial_gate, channel_squeeze, channel_expand, spatial_bn, "
                           "channel_bn")])
def test_multihead_torch_checkpoint_without_heads_is_refused(tmp_path, name, heads):
    """A torch checkpoint in the reference ResNet-50 scheme has no keys for
    these models' heads: the JAX package's forward fails on them, the port
    refuses the file and names them. A file with every head loads."""
    model = get_model(name, img_size=(64, 32)).module
    full = model.state_dict()
    trunk = {k: v for k, v in full.items() if k.startswith(("conv1", "bn1", "layer"))}
    trunk.update({k: v for k, v in full.items() if k.startswith("last_bn")})
    torch.save(trunk, tmp_path / "trunk.pt")
    with pytest.raises(ValueError, match=heads):
        load_state(name, str(tmp_path / "trunk.pt"), model)
    torch.save(full, tmp_path / "full.pt")
    model.load_state_dict(load_state(name, str(tmp_path / "full.pt"), model), strict=True)


def test_factory_ports_fourteen_of_eighteen_models():
    """The ResNet and ViT families' 14 names, and since the rest of the CNN
    zoo was ported, the other 4 as well: all 18 of the JAX registry."""
    # the names the JAX factory registers itself: other test modules
    # register more into the live JAX registry
    names = set(re.findall(r'@register_model\("(\w+)"\)', inspect.getsource(jax_factory)))
    assert len(names) == 18
    # and the named set of models that exist only in the port
    assert set(port_factory.MODEL_REGISTRY) == names | port_factory.PORT_ONLY_MODELS
    assert get_model("osnet").feature_dim == 512
    with pytest.raises(KeyError, match="not yet ported"):
        get_model("vit_base")


def _jpeg_table(tmp_path, n=6, size=(40, 20)):
    paths = []
    for i, im in enumerate(_images(size, n=n, seed=7)):
        paths.append(str(tmp_path / f"{i}.png"))  # lossless: the decode is exact
        Image.fromarray(im).save(paths[-1])
    return paths


def test_extractor_returns_each_head_trimmed_and_concatenated(tmp_path):
    """Six images through batches of 4 (a padded tail): one (6, D_h) array
    per head, equal to one forward over all six."""
    paths = _jpeg_table(tmp_path)
    model = port_resnet.MultiPartResNet50ReID(stage_sizes=STAGES).eval()
    port_factory.init_weights(model, torch.Generator().manual_seed(0))
    bundle = ModelBundle(module=model, feature_dim=2048, name="multipart_resnet50")
    got = FeatureExtractor(bundle, img_size=(40, 20), batch_size=4, device="cpu").extract(paths)
    with torch.inference_mode():
        want = model(normalize_images(torch.from_numpy(_images((40, 20), n=6, seed=7))))
    assert isinstance(got, tuple) and len(got) == 4
    for g, w in zip(got, want):
        assert g.shape == (6, 2048) and g.dtype == np.float32
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-5 * float(w.abs().max()))


def test_serve_sizes_its_index_from_the_extracted_width(tmp_path):
    """A multipart daemon enrolls 4 x 2048 = 8192-wide rows (its bundle says
    2048) and answers a search by paths."""
    paths = _jpeg_table(tmp_path)
    model = port_resnet.MultiPartResNet50ReID(stage_sizes=STAGES).eval()
    bundle = ModelBundle(module=model, feature_dim=2048, name="multipart_resnet50")
    service = port_serve.IdentificationService(
        FeatureExtractor(bundle, img_size=(40, 20), batch_size=4, device="cpu"), None,
        device="cpu")
    r = service.handle({"op": "enroll", "paths": paths, "pids": list(range(6))})
    assert r["ok"] and r["num_gallery"] == 6, r
    assert service.index._host_buf.shape[1] == 8192
    r = service.handle({"op": "search", "paths": paths[:2], "topk": 3})
    assert r["ok"] and [row[0] for row in r["pids"]] == [0, 1], r


@pytest.mark.parametrize("name", sorted(port_factory.MULTIHEAD_MODELS))
def test_train_cli_refuses_a_multihead_model(tmp_path, name):
    args = port_train.build_argparser().parse_args(
        ["--dataset", "Synthetic", "--data_root", str(tmp_path), "--device", "cpu",
         "--model_name", name])
    with pytest.raises(SystemExit, match="tuple of head embeddings"):
        port_train.main(args)
    assert not (tmp_path / "Synthetic").exists()  # refused before any data work


def test_resnet50ibn_one_step_lockstep_with_the_jax_train_step(tmp_path):
    """One optimizer step of the IBN trunk (InstanceNorm in train mode
    beside train-mode BN) on a pre-augmented paired batch of 16, from the
    same weights on both sides."""
    img = (32, 16)
    kw = dict(img_size=img, base_lr=1e-3, weight_decay=5e-4, tau=0.05, beta=0.9,
              lambda_proxy=0.4, lambda_distortion=0.5, num_epochs=4, num_proxies=3, seed=5,
              extractor_batch=16)
    splits, turb = make_synthetic_dataset(str(tmp_path), num_ids=4, imgs_per_id_train=3,
                                          imgs_per_id_test=2, height=img[0], width=img[1])
    table = splits["train"]
    module = flax_resnet.ResNet50ReID(stage_sizes=STAGES, ibn=True)
    variables = _randomized(module.init(jax.random.key(0), jnp.zeros((1, *img, 3))))
    jt = JaxTable(table.paths, table.pids, table.camids, table.kinds, "Synthetic")
    jtr = jax_trainer.Trainer(
        JaxBundle(module=module, variables=variables, feature_dim=2048, name="ibn"),
        JaxBundle(module=module, variables=jax.tree.map(np.copy, variables), feature_dim=2048,
                  name="ibn"),
        JaxSampler(jt, jt.pids, P=2, K=4, kind_of_transform=1, turbulence_dir=turb, seed=5),
        compute_dtype=jnp.float32, **kw)

    rng = np.random.default_rng(0)
    b = 16
    u8 = rng.integers(0, 256, (b, *img, 3), dtype=np.uint8)
    scal = draw_scalars(b, *img, 10, 0.4, 0.3, 0.4, (0.05, 0.30), (0.3, 3.3),
                        torch.Generator().manual_seed(0))
    images = fused_augment_plain(torch.from_numpy(u8), scal, 10, torch.float32)
    labels = np.repeat(np.arange(4), 4).astype(np.int32)
    dist = np.stack([np.zeros(b // 2), rng.integers(1, 6, b // 2)], 1).reshape(-1).astype(np.int32)
    mask = np.ones(b, bool)
    mask[6:8] = False
    unit = lambda a: (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)
    centers, proxies = unit(rng.normal(size=(4, 2048))), unit(rng.normal(size=(12, 2048)))
    plabels = np.asarray([0, 0, 0, 1, 1, -1, 2, -1, -1, 3, 3, 3], np.int32)
    new, metrics = jax.device_get(jtr._train_step(
        jtr.state, images.permute(0, 2, 3, 1).contiguous().numpy(), labels, dist, mask,
        np.zeros(b, np.int32), centers, proxies, plabels, jnp.float32(1), jax.random.key(0)))

    model = port_resnet.ResNet50ReID(stage_sizes=STAGES, ibn=True)
    model.load_state_dict(variables_from_jax("resnet50IBN", variables), strict=True)
    twin = port_resnet.ResNet50ReID(stage_sizes=STAGES, ibn=True)
    twin.load_state_dict(model.state_dict())
    tr = port_trainer.Trainer(
        ModelBundle(module=model, feature_dim=2048, name="ibn"),
        ModelBundle(module=twin, feature_dim=2048, name="ibn"),
        PKBatchSampler(table, table.pids, P=2, K=4, kind_of_transform=1, turbulence_dir=turb,
                       seed=5),
        compute_dtype=torch.float32, decode_workers=2, **kw)
    tr.set_epoch_hyperparams(1)
    t = torch.from_numpy
    m = tr.forward_backward(images, t(labels).long(), t(dist).long(), t(mask), t(centers),
                            t(proxies), t(plabels).long(), 1)
    weights_sum = tr.apply_update()
    got = dict(zip(port_trainer.METRICS, [*m.tolist(), weights_sum.item()]))
    for name in ("loss", "center_loss", "proxy_loss", "batch_acc_bal", "weights_sum"):
        assert got[name] == pytest.approx(float(metrics[name]), rel=1e-4), name

    names = dict(tr.online.named_parameters())
    adam = [s for s in jax.tree_util.tree_leaves(
        new.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    assert len(adam) == 1
    mu = params_from_jax("resnet50IBN", adam[0].mu)
    nu = params_from_jax("resnet50IBN", adam[0].nu)
    assert mu.keys() == names.keys()
    assert any(".bn1.IN." in k for k in mu)
    state = tr.optimizer.state
    assert max(float((state[names[k]]["exp_avg"] - mu[k]).abs().max()) for k in mu) <= 1e-5
    assert max(float((state[names[k]]["exp_avg_sq"] - nu[k]).abs().max()) for k in nu) <= 1e-5
    online = variables_from_jax("resnet50IBN", {"params": new.params,
                                                "batch_stats": new.batch_stats})
    running = [k for k in online if "running" in k]
    assert any(".bn1.BN." in k for k in running)
    port_online = tr.online.state_dict()
    assert max(float((port_online[k] - online[k]).abs().max()) for k in running) <= 1e-5
