"""``export`` of the PyTorch port against the JAX package, on the CPU: an
``.npz`` → a reference torch pickle, for the CNN families of
``tests/test_torch_export.py`` (same inputs, same drawn variables); the
multi-head ResNets refused to a torch pickle, by the names of their heads,
and exported to an ``.npz`` that the JAX package's ``load_variables``
reads (a ``.pt`` of the port's train CLI carried to the JAX package:
``tests/test_torch_export_trained.py``).
"""

import jax
import numpy as np
import pytest
import torch

from daliid_tpu.train import checkpoint as jax_checkpoint
from daliid_tpu_torch.cli import export as port_export
from daliid_tpu_torch.models import factory as port_factory
from daliid_tpu_torch.models.torch_port import _HEADS_WITHOUT_TORCH_KEYS, variables_to_jax
from tests.test_torch_export import (  # noqa: F401 (drawn_jax_models is a fixture)
    FAMILIES,
    IMG,
    MULTIHEAD,
    SIZES,
    _argv,
    _both,
    _drawn,
    _module,
    drawn_jax_models,
)


@pytest.mark.parametrize("name,num_classes", FAMILIES)
def test_npz_to_torch_matches_the_jax_export(drawn_jax_models, tmp_path, name, num_classes):
    src = tmp_path / "weights.npz"
    module = _module(name, num_classes)
    jax_checkpoint.save_variables(str(src), _drawn(module, SIZES.get(name, IMG)))
    jax_out, port_out = _both(tmp_path, name, src, ".pth", num_classes)
    want, got = torch.load(jax_out, weights_only=True), torch.load(port_out, weights_only=True)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype and torch.equal(got[key], w), key


@pytest.mark.parametrize("name", MULTIHEAD)
def test_port_refuses_a_multihead_resnet_to_torch_and_exports_its_npz(tmp_path, name):
    module = port_factory.get_model(name, img_size=IMG).module
    pt, npz = tmp_path / "w.pt", tmp_path / "w.npz"
    torch.save(module.state_dict(), pt)
    with pytest.raises(SystemExit) as refused:
        port_export.main(port_export.build_argparser().parse_args(
            _argv(name, npz, tmp_path / "w.pth", 0) + ["--device", "cpu"]))
    assert all(h in str(refused.value) for h in _HEADS_WITHOUT_TORCH_KEYS[name])
    assert ".npz" in str(refused.value) and not (tmp_path / "w.pth").exists()
    port_export.main(port_export.build_argparser().parse_args(
        _argv(name, pt, npz, 0) + ["--device", "cpu"]))
    template = _drawn(_module(name, 0))
    got = jax_checkpoint.load_variables(str(npz), template)  # every leaf at its shape
    want = variables_to_jax(name, module.state_dict())
    assert jax.tree.all(jax.tree.map(np.array_equal, got, want))
