"""Swin-B (``models/swin.py``, port only) on the CPU: the program against the
benchmark's plain float32 reference, the biased attention's plain version
and gradient, the port's normal training path, and the refusals of every
path that converts to or from the JAX package's layout.

A tiny Swin (width 16, two blocks a stage, window 3, shift 1, 4x4 patches)
at 40x24, whose 10x6 and 5x3 grids are padded to 12x6 and 6x3, so the
zero-padded keys, the shift mask and the relative-position bias all reach
the embedding. The bias tables are drawn at std 1 (not the init's 0.02):
a transposed index, a dropped mask or a missing pad then moves the
embedding by tenths where the two sides agree to 1e-6.

The program's two attention routes are each held to the reference: the
biased kernel's (whose wrapper computes the plain version on the CPU; the
route is forced here, since on its own it takes the kernel only for bf16
on a CUDA device) and ``scaled_dot_product_attention``'s, which every other
call takes.

Tolerances: the embeddings (f32, the same operations in another order)
within 1e-5 relative L2 a row; the plain attention and its gradient
against autograd through ``softmax(q k^T s + bias) v`` within 1e-5 of the
largest magnitude.
"""

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

import daliid_tpu_torch.models.factory as port_factory
import daliid_tpu_torch.models.swin as port_swin
from daliid_tpu_torch.cli import export as port_export
from daliid_tpu_torch.data import make_synthetic_dataset
from daliid_tpu_torch.models import torch_port
from daliid_tpu_torch.models.swin import SwinReID
from daliid_tpu_torch.ops.flash_attention import (
    attention_backward,
    attention_plain,
    flash_attention,
)
from daliid_tpu_torch.train.sampler import PKBatchSampler
from daliid_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=3, shift_size=1,
            patch_size=4, drop_path_rate=0.1)
IMG = (40, 24)


def _reference():
    """``benchmark/reference/swin.py``, loaded by its path."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("reference_swin",
                                                  ROOT / "benchmark/reference/swin.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _weights(ref, cfg, seed):
    """Seeded weights of the reference's spec, the bias tables at std 1."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, init in ref.spec(cfg):
        if init == "ones":
            out[name] = torch.ones(shape)
        elif init == "zeros" and not name.endswith("bias"):
            out[name] = torch.zeros(shape)
        elif init == "zeros":
            out[name] = 0.1 * torch.randn(shape, generator=gen)
        elif init == "token":
            out[name] = torch.randn(shape, generator=gen)
        else:
            out[name] = torch.randn(shape, generator=gen) / torch.Size(shape[1:]).numel() ** 0.5
    return out


def _route(monkeypatch, route: str) -> list:
    """Force the windowed attention's route; → the calls it records."""
    calls = []
    take = route == "kernel"
    monkeypatch.setattr(port_swin, "bias_kernel_takes", lambda q: calls.append(route) or take)
    return calls


@pytest.mark.parametrize("route", ["kernel", "sdpa"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_swin_matches_the_plain_reference_in_float32(train, route, monkeypatch):
    ref = _reference()
    cfg = dict(TINY, img_size=list(IMG), mlp_ratio=4.0)
    w = _weights(ref, cfg, 3)
    model = SwinReID(img_size=IMG, remat="tuned", **TINY)
    model.load_state_dict(w, strict=True)
    model.train(train)
    x = torch.randn(4, 3, *IMG, generator=torch.Generator().manual_seed(2))
    calls = _route(monkeypatch, route)
    n0 = flash_attention.bias_launches
    got = model(x, generator=torch.Generator().manual_seed(8))
    assert calls == [route] * 4 and flash_attention.bias_launches == n0
    P = {k: v.clone() for k, v in w.items()}
    want = ref.forward(cfg, P, x, train, generator=torch.Generator().manual_seed(8))
    assert got.shape == (4, 32) and want.shape == (4, 32)
    gap = ((got - want).norm(dim=1) / want.norm(dim=1)).max()
    assert gap < 1e-5, gap
    if train:  # the neck's running statistics moved alike
        for k in ("running_mean", "running_var"):
            got_k, want_k = model.bottleneck.state_dict()[k], P[f"bottleneck.{k}"]
            assert not torch.equal(want_k, w[f"bottleneck.{k}"])
            assert torch.allclose(got_k, want_k, atol=1e-6)


@pytest.mark.parametrize("g", [1, 3])
def test_biased_attention_and_its_gradient_match_autograd(g):
    gen = torch.Generator().manual_seed(4)
    b, n, h, d = 6, 9, 2, 32
    q, k, v = (torch.randn(b, n, h, d, generator=gen, requires_grad=True) for _ in range(3))
    bias = torch.randn(g, h, n, n, generator=gen) - 100.0 * (
        torch.rand(g, 1, n, n, generator=gen) < 0.3)
    bias.requires_grad_()
    out_g = torch.randn(b, n, h, d, generator=gen)

    def direct(q, k, v, bias):
        s = torch.einsum("bnhd,bmhd->bhnm", q, k) * d ** -0.5
        s = (s.view(b // g, g, h, n, n) + bias).view(b, h, n, n)
        return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, dim=-1), v)

    want = direct(q, k, v, bias)
    want.backward(out_g)
    grads = [t.grad.clone() for t in (q, k, v, bias)]
    got = attention_plain(q.detach(), k.detach(), v.detach(), bias.detach())
    assert (got - want).abs().max() < 1e-5 * want.abs().max()
    back = attention_backward(q.detach(), k.detach(), v.detach(), out_g, bias.detach())
    assert len(back) == 4
    for a, e in zip(back, grads):
        assert a.shape == e.shape and (a - e).abs().max() < 1e-5 * e.abs().max()
    # through the autograd Function (the plain version on the CPU)
    for t in (q, k, v, bias):
        t.grad = None
    n0 = flash_attention.bias_launches
    flash_attention(q, k, v, bias).backward(out_g)
    assert flash_attention.bias_launches == n0  # no kernel on the CPU
    for t, e in zip((q, k, v, bias), grads):
        assert (t.grad - e).abs().max() < 1e-5 * e.abs().max()
    with pytest.raises(ValueError, match="bias must be"):
        flash_attention(q, k, v, bias[:, :1])


def _tiny_swin(dtype=torch.float32, img_size=IMG, remat="none", **kw):
    return SwinReID(img_size=img_size, dtype=dtype, remat=remat, **TINY), 32


def test_swin_base_trains_and_mines_through_the_normal_path(monkeypatch, tmp_path):
    """``build_model_pair('swin_base')`` (tiny widths under the real name),
    ``Trainer``: one epoch of P2 K2 paired steps, its mining through the
    ``FeatureExtractor`` first, on a synthetic tree at 64x32."""
    monkeypatch.setitem(port_factory.MODEL_REGISTRY, "swin_base", _tiny_swin)
    img = (64, 32)
    splits, turb = make_synthetic_dataset(str(tmp_path), num_ids=3, imgs_per_id_train=2,
                                          imgs_per_id_test=1, height=img[0], width=img[1])
    table = splits["train"]
    online, momentum = port_factory.build_model_pair(
        "swin_base", torch.Generator().manual_seed(1), img_size=img, remat="tuned")
    tables = [m.attn.relative_position_bias_table for m in online.module.modules()
              if hasattr(m, "attn")]
    assert tables and all(0 < float(t.detach().std()) < 0.03 for t in tables)  # trunc-normal(0.02)
    before = {k: v.clone() for k, v in online.module.state_dict().items()}
    sampler = PKBatchSampler(table, table.pids, P=2, K=2, kind_of_transform=1,
                             turbulence_dir=turb, dataset="Synthetic", seed=5)
    trainer = Trainer(online, momentum, sampler, img_size=img, base_lr=1e-3, tau=0.05,
                      beta=0.9, lambda_proxy=0.4, num_epochs=4, num_proxies=2, seed=5,
                      compute_dtype=torch.float32, decode_workers=1, extractor_batch=4)
    stats = trainer.train_epoch(1)
    assert all(v == v for v in stats.values())
    after = online.module.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert any(k.endswith("relative_position_bias_table") for k in moved)
    feats = trainer.extractor.extract(table)
    assert feats.shape == (len(table), 32)


def test_jax_layout_paths_refuse_swin_base(monkeypatch, tmp_path):
    monkeypatch.setitem(port_factory.MODEL_REGISTRY, "swin_base", _tiny_swin)
    sd = port_factory.get_model("swin_base").module.state_dict()
    for convert in (torch_port.variables_to_jax, torch_port.state_to_torch):
        with pytest.raises(ValueError, match="swin_base exists only in the port"):
            convert("swin_base", sd)
    for convert in (torch_port.variables_from_jax, torch_port.params_from_jax):
        with pytest.raises(ValueError, match="swin_base exists only in the port"):
            convert("swin_base", {"params": {}})
    with pytest.raises(ValueError, match="swin_base exists only in the port"):
        torch_port.load_state("swin_base", str(tmp_path / "weights.npz"))
    src = tmp_path / "model.pt"
    torch.save(sd, src)
    # the port's own state_dict loads back as it is
    assert set(torch_port.load_state("swin_base", str(src))) == set(sd)
    args = port_export.build_argparser().parse_args(
        ["--model_name", "swin_base", "--input", str(src), "--output",
         str(tmp_path / "out.npz"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="swin_base exists only in the port"):
        port_export.main(args)
