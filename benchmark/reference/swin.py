"""Swin Transformer as a re-ID encoder, as a plain function of its
parameters.

Liu et al., *Swin Transformer*, ICCV 2021 (arXiv:2103.14030), with the
padding rule of the detection and re-ID codebases (mmdet's
``ShiftWindowMSA``: the normed grid zero-padded right and bottom to
multiples of the window, the padded zeros kept as keys, the shift kept in
every stage) and a re-ID head (LayerNorm, the mean over the last stage's
tokens, a BN neck), as SOLIDER (arXiv:2303.17602) runs Swin at 384x128
without its semantic controller. Pre-norm blocks, LayerNorm eps 1e-5,
exact GELU, attention ``softmax(q k^T / sqrt(head dim) + B + mask) v``
within M x M windows, B the relative-position bias ``table[idx]`` with
``idx[n, m] = (r_n - r_m + M - 1)(2M - 1) + (c_n - c_m + M - 1)``, the mask
-100 between tokens of different regions of a shifted grid. Patch merging
concatenates ``x[0::2, 0::2]``, ``x[1::2, 0::2]``, ``x[0::2, 1::2]``,
``x[1::2, 1::2]``, then LayerNorm and a bias-free reduction. Keys are the
original's (``layers.2.blocks.5.attn.relative_position_bias_table``,
``layers.0.downsample.reduction.weight``, ``patch_embed.norm.bias``,
``norm.weight``, ``bottleneck.running_var``, ...).

Stochastic depth rises linearly from 0 to ``drop_path_rate`` over all the
blocks and draws one uniform per sample, attention's residual first, then
the MLP's, for each block whose rate is above 0, from the generator passed
in; a generator seeded alike on the same device draws the same masks.

The widths come from the configuration (``benchmark/configs/*.json``):
``embed_dim``, ``depths``, ``num_heads``, ``window_size``, ``shift_size``,
``mlp_ratio``, ``patch_size`` and ``drop_path_rate``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.precision import Precision

EPS = 1e-5


def _mlp(dim: int, cfg: dict) -> int:
    return int(dim * cfg["mlp_ratio"])


def _widths(cfg: dict) -> list:
    return [cfg["embed_dim"] * 2 ** i for i in range(len(cfg["depths"]))]


def _ln_spec(name: str, dim: int) -> list:
    return [(f"{name}.weight", (dim,), "ones"), (f"{name}.bias", (dim,), "zeros")]


def spec(cfg: dict) -> list:
    """[(name, shape, init)]: ``fan_in``, ``ones``, ``zeros`` or ``token``
    (truncated normal, std 0.02 at +-2 std) for the bias tables."""
    c, p, m = cfg["embed_dim"], cfg["patch_size"], cfg["window_size"]
    out = [("patch_embed.proj.weight", (c, 3, p, p), "fan_in"),
           ("patch_embed.proj.bias", (c,), "zeros")] + _ln_spec("patch_embed.norm", c)
    widths = _widths(cfg)
    for i, (depth, heads, dim) in enumerate(zip(cfg["depths"], cfg["num_heads"], widths)):
        for j in range(depth):
            b, hid = f"layers.{i}.blocks.{j}", _mlp(dim, cfg)
            out += _ln_spec(f"{b}.norm1", dim) + [
                (f"{b}.attn.qkv.weight", (3 * dim, dim), "fan_in"),
                (f"{b}.attn.qkv.bias", (3 * dim,), "zeros"),
                (f"{b}.attn.proj.weight", (dim, dim), "fan_in"),
                (f"{b}.attn.proj.bias", (dim,), "zeros"),
                (f"{b}.attn.relative_position_bias_table", ((2 * m - 1) ** 2, heads), "token"),
            ] + _ln_spec(f"{b}.norm2", dim) + [
                (f"{b}.mlp.fc1.weight", (hid, dim), "fan_in"), (f"{b}.mlp.fc1.bias", (hid,), "zeros"),
                (f"{b}.mlp.fc2.weight", (dim, hid), "fan_in"), (f"{b}.mlp.fc2.bias", (dim,), "zeros"),
            ]
        if i + 1 < len(widths):
            out += _ln_spec(f"layers.{i}.downsample.norm", 4 * dim) + [
                (f"layers.{i}.downsample.reduction.weight", (2 * dim, 4 * dim), "fan_in")]
    dim = widths[-1]
    return out + _ln_spec("norm", dim) + [
        ("bottleneck.weight", (dim,), "ones"), ("bottleneck.bias", (dim,), "zeros"),
        ("bottleneck.running_mean", (dim,), "zeros"), ("bottleneck.running_var", (dim,), "ones")]


def _ln(P, name, x):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], EPS)


def _linear(P, name, x, prec, bias=True):
    b = P[f"{name}.bias"] if bias else None
    return prec.grad(F.linear(prec(x), prec(P[f"{name}.weight"]), b))


def _windows(x, m):
    """(B, Hp, Wp, C) → (B, nW, M², C), windows in row-major order."""
    b, h, w, c = x.shape
    return x.view(b, h // m, m, w // m, m, c).permute(0, 1, 3, 2, 4, 5).reshape(b, -1, m * m, c)


def _grid(x, m, h, w):
    """The inverse of :func:`_windows` for an (Hp, Wp) = (h, w) grid."""
    b, _, _, c = x.shape
    return x.view(b, h // m, w // m, m, m, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _relative_bias(P, name, m):
    """(heads, M², M²): entry (n, m') of the table row for their offset."""
    r = torch.arange(m).repeat_interleave(m)
    c = torch.arange(m).repeat(m)
    idx = (r[:, None] - r[None, :] + m - 1) * (2 * m - 1) + (c[:, None] - c[None, :] + m - 1)
    table = P[f"{name}.relative_position_bias_table"]
    return table[idx.to(table.device)].permute(2, 0, 1)


def _region_mask(hp, wp, m, s, device):
    """(nW, M², M²): -100 between tokens of different regions, else 0."""
    rows = torch.zeros(hp, dtype=torch.long)
    rows[hp - m:hp - s], rows[hp - s:] = 1, 2
    cols = torch.zeros(wp, dtype=torch.long)
    cols[wp - m:wp - s], cols[wp - s:] = 1, 2
    region = (rows[:, None] * 3 + cols[None, :]).float()[None, :, :, None]
    ids = _windows(region, m)[0, :, :, 0]
    return torch.where(ids[:, :, None] == ids[:, None, :], 0.0, -100.0).to(device)


def _block(cfg, P, name, x, hw, heads, shift, prec, u1=None, u2=None, rate=0.0):
    m = cfg["window_size"]
    (h, w), (b, _, dim) = hw, x.shape
    hp, wp = -(-h // m) * m, -(-w // m) * m
    hd = dim // heads
    t = F.pad(_ln(P, f"{name}.norm1", x).view(b, h, w, dim), (0, 0, 0, wp - w, 0, hp - h))
    if shift:
        t = torch.roll(t, (-shift, -shift), (1, 2))
    win = _windows(t, m)                                        # (B, nW, N, C)
    nw, n = win.shape[1], win.shape[2]
    qkv = _linear(P, f"{name}.attn.qkv", win, prec).view(b, nw, n, 3, heads, hd)
    q, k, v = (qkv[:, :, :, i].transpose(2, 3) for i in range(3))  # (B, nW, heads, N, hd)
    s = prec.grad(prec(q) @ prec(k).transpose(-2, -1)) * hd ** -0.5
    s = s + _relative_bias(P, f"{name}.attn", m)
    if shift:
        s = s + _region_mask(hp, wp, m, shift, x.device)[:, None]
    att = torch.softmax(s, dim=-1)
    y = prec.grad(prec(att) @ prec(v)).transpose(2, 3).reshape(b, nw, n, dim)
    y = _grid(_linear(P, f"{name}.attn.proj", y, prec), m, hp, wp)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    y = y[:, :h, :w].reshape(b, h * w, dim)
    keep = 1.0 - rate
    if u1 is not None:
        y = y / keep * (u1 < keep).float()
    x = x + y
    y = _linear(P, f"{name}.mlp.fc2", F.gelu(_linear(P, f"{name}.mlp.fc1",
                                                      _ln(P, f"{name}.norm2", x), prec)), prec)
    if u2 is not None:
        y = y / keep * (u2 < keep).float()
    return x + y


def _merge(P, name, x, hw, prec):
    (h, w), (b, _, dim) = hw, x.shape
    t = F.pad(x.view(b, h, w, dim), (0, 0, 0, w % 2, 0, h % 2))
    t = torch.cat([t[:, 0::2, 0::2], t[:, 1::2, 0::2], t[:, 0::2, 1::2], t[:, 1::2, 1::2]], -1)
    hw = (t.shape[1], t.shape[2])
    t = _ln(P, f"{name}.norm", t.reshape(b, hw[0] * hw[1], 4 * dim))
    return _linear(P, f"{name}.reduction", t, prec, bias=False), hw


def forward(cfg: dict, P: dict, x: torch.Tensor, train: bool = False,
            prec: Precision | None = None, generator: torch.Generator | None = None):
    """(B, 3, H, W) normalized float32 images → the (B, 8C) embedding after
    the BN neck (batch statistics in train mode, which also updates the
    running ones)."""
    prec = prec or Precision()
    p = cfg["patch_size"]
    t = prec.grad(F.conv2d(prec(x), prec(P["patch_embed.proj.weight"]),
                           P["patch_embed.proj.bias"], p))
    hw = (t.shape[2], t.shape[3])
    t = _ln(P, "patch_embed.norm", t.permute(0, 2, 3, 1).flatten(1, 2))
    total, k = sum(cfg["depths"]), 0
    b = x.shape[0]
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        for j in range(depth):
            rate = cfg["drop_path_rate"] * k / max(total - 1, 1)
            k += 1
            u1 = u2 = None
            if train and rate > 0.0:
                u1, u2 = (torch.rand((b, 1, 1), generator=generator, device=x.device)
                          for _ in range(2))
            args = (cfg, P, f"layers.{i}.blocks.{j}", t, hw, heads,
                    cfg["shift_size"] if j % 2 else 0, prec, u1, u2, rate)
            if torch.is_grad_enabled():
                # recomputed in the backward, so that float32 activations fit
                t = checkpoint(_block, *args, use_reentrant=False)
            else:
                t = _block(*args)
        if i + 1 < len(cfg["depths"]):
            t, hw = _merge(P, f"layers.{i}.downsample", t, hw, prec)
    f = _ln(P, "norm", t).mean(dim=1)
    return F.batch_norm(f, P["bottleneck.running_mean"], P["bottleneck.running_var"],
                        P["bottleneck.weight"], P["bottleneck.bias"], training=train,
                        momentum=0.1, eps=1e-5)


def grids(cfg: dict) -> list:
    """Each stage's (H, W) token grid and its window-padded (Hp, Wp)."""
    (h, w), p, m = cfg["img_size"], cfg["patch_size"], cfg["window_size"]
    h, w = -(-h // p), -(-w // p)
    out = []
    for i in range(len(cfg["depths"])):
        if i:
            h, w = -(-h // 2), -(-w // 2)
        out.append(((h, w), (-(-h // m) * m, -(-w // m) * m)))
    return out


def flops(cfg: dict, train: bool = False) -> float:
    """Model FLOPs of one image's forward (no classifier, so training counts
    the same): the patch embedding; in every block qkv, the attention's
    QK^T and AV and the projection over the padded windows, the MLP over
    the real tokens; patch merging."""
    (h0, w0), p, m = cfg["img_size"], cfg["patch_size"], cfg["window_size"]
    c0 = cfg["embed_dim"]
    macs = -(-h0 // p) * -(-w0 // p) * c0 * 3 * p * p
    n = m * m
    for (depth, dim), ((h, w), (hp, wp)) in zip(zip(cfg["depths"], _widths(cfg)), grids(cfg)):
        padded = hp * wp
        block = padded * 4 * dim * dim + 2 * padded * n * dim + 2 * h * w * dim * _mlp(dim, cfg)
        macs += depth * block
    for (dim, ((h, w), _)) in list(zip(_widths(cfg), grids(cfg)))[:-1]:
        macs += -(-h // 2) * -(-w // 2) * 4 * dim * 2 * dim
    return 2.0 * macs


def attention(cfg: dict) -> list:
    """K4's unbiased launches a forward: none (every attention is biased)."""
    return []


def window_attention(cfg: dict) -> list:
    """The biased kernel's launches a forward: [(launches, windows an image,
    tokens, heads, head dim, G)] for each stage's unshifted blocks (one bias
    for every window, G = 1) and shifted ones (the mask's, G = windows)."""
    m = cfg["window_size"]
    out = []
    for (depth, heads, dim), (_, (hp, wp)) in zip(
            zip(cfg["depths"], cfg["num_heads"], _widths(cfg)), grids(cfg)):
        nw = (hp // m) * (wp // m)
        out.append(((depth + 1) // 2, nw, m * m, heads, dim // heads, 1))
        if depth > 1:
            out.append((depth // 2, nw, m * m, heads, dim // heads, nw))
    return out
