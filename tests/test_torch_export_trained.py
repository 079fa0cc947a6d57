"""A model trained with the PyTorch port reaches the JAX package (CPU): one
epoch of the port's train CLI on a ResNet of one block a stage (rebound as
``resnet50`` in the port's registry), its ``model_online_*.pt`` exported
to an ``.npz`` by the port's ``export``, read by the JAX package's
``load_variables`` and run by the flax module: within 1e-4 of the largest
embedding entry of the port's forward on the same weights (the zoo tests'
tolerance: float32 summation order in the convolutions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from daliid_tpu.augment.preprocess import normalize_images as jax_normalize
from daliid_tpu.models.resnet import ResNet50ReID as FlaxResNet
from daliid_tpu.train import checkpoint as jax_checkpoint
from daliid_tpu_torch.augment.preprocess import normalize_images
from daliid_tpu_torch.cli import export as port_export
from daliid_tpu_torch.cli import train as port_train
from daliid_tpu_torch.data import make_synthetic_dataset
from daliid_tpu_torch.data import native_loader as port_native_loader
from daliid_tpu_torch.models import factory as port_factory
from daliid_tpu_torch.models.resnet import ResNet50ReID
from daliid_tpu_torch.models.torch_port import load_state


def test_port_trained_weights_reach_the_jax_package(tmp_path, monkeypatch):
    stages = (1, 1, 1, 1)
    monkeypatch.setitem(port_factory.MODEL_REGISTRY, "resnet50",
                        lambda dtype, feature="both", **kw: (
                            ResNet50ReID(stage_sizes=stages, dtype=dtype, feature=feature),
                            2048))
    monkeypatch.setattr(port_native_loader, "native_loader_available", lambda: False)
    make_synthetic_dataset(str(tmp_path / "data" / "Synthetic"), num_ids=4, imgs_per_id_train=2,
                           imgs_per_id_test=2, height=32, width=16)
    ckpt = tmp_path / "ckpt"
    port_train.main(port_train.build_argparser().parse_args(
        ["--dataset", "Synthetic", "--data_root", str(tmp_path / "data"), "--device", "cpu",
         "--img_height", "32", "--img_width", "16", "--P", "2", "--K", "2", "--epochs", "1",
         "--eval_freq", "1", "--compute_dtype", "float32", "--extractor_batch", "16",
         "--kind_of_transform", "0", "--path_to_save_models", str(ckpt),
         "--path_to_save_metrics", str(tmp_path / "metrics")]))
    pt, npz = ckpt / "model_online_resnet50_v0.pt", tmp_path / "online.npz"
    port_export.main(port_export.build_argparser().parse_args(
        ["--model_name", "resnet50", "--input", str(pt), "--output", str(npz), "--device",
         "cpu"]))
    flax = FlaxResNet(stage_sizes=stages)
    template = jax.tree.map(np.asarray, flax.init(jax.random.key(0), jnp.zeros((1, 32, 16, 3)),
                                                  train=False))
    variables = jax_checkpoint.load_variables(str(npz), template)
    images = np.random.default_rng(0).integers(0, 256, (4, 32, 16, 3), dtype=np.uint8)
    want = np.asarray(flax.apply(variables, jax_normalize(jnp.asarray(images)), train=False))
    port = ResNet50ReID(stage_sizes=stages).eval()
    port.load_state_dict(load_state("resnet50", str(pt)), strict=True)
    with torch.inference_mode():
        got = port(normalize_images(torch.from_numpy(images))).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
