"""TransReID with the Jigsaw Patch Module, as a plain function of its
parameters.

He et al., *TransReID*, ICCV 2021 (arXiv:2102.04378), as its reference code
builds it (``make_models.py:221-389``, ``build_transformer_local``): a
ViT-B/16 trunk over overlapping 16x16 patches at stride 12 (211 tokens at
256x128), run to depth - 1 with linear stochastic depth up to 0.1; a global
branch (one block and a LayerNorm, its cls token the global feature); the
JPM branch, which shifts the patch tokens by 5, shuffles them in 2 groups and
splits them into 4 chunks of 52, each behind the cls token through one
shared block and LayerNorm; five BN necks and, with classes, five bias-free
classifiers. Pre-norm blocks, LayerNorm eps 1e-6, exact GELU, attention
``softmax(q k^T / sqrt(64)) v`` over 12 heads. Keys are the reference's
(``base.blocks.3.attn.qkv.weight``, ``b1.0.mlp.fc1.bias``, ``b2.1.weight``,
``bottleneck_2.running_var``, ``classifier_4.weight``, ...).

Stochastic depth draws one uniform per sample, attention's residual first,
then the MLP's, for each trunk block whose rate is above 0, from the
generator passed in; a generator seeded alike on the same device draws the
same masks.

The widths come from the configuration (``benchmark/configs/*.json``), under
the program's argument names: ``embed_dim``, ``depth``, ``num_heads``,
``mlp_ratio``, ``patch_size``, ``patch_stride``, ``drop_path_rate``,
``divide_length``, ``shift_num``, ``shuffle_groups`` and ``num_classes``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.precision import Precision
from benchmark.roofline import models

# TransReID-JPM as ``benchmark/configs/transreid_jpm.json`` states it
TRANSREID_JPM = {"img_size": [256, 128], "embed_dim": 768, "depth": 12, "num_heads": 12,
                 "mlp_ratio": 4.0, "patch_size": 16, "patch_stride": 12,
                 "drop_path_rate": 0.1, "divide_length": 4, "shift_num": 5,
                 "shuffle_groups": 2, "num_classes": 0}
LOCAL_SCALE = 4.0  # each local feature's share of the embedding (make_models.py:383)


def grid(cfg: dict) -> tuple:
    (h, w), p, s = cfg["img_size"], cfg["patch_size"], cfg["patch_stride"]
    return (h - p) // s + 1, (w - p) // s + 1


def tokens(cfg: dict) -> int:
    gh, gw = grid(cfg)
    return 1 + gh * gw


def _mlp(cfg: dict) -> int:
    return int(cfg["embed_dim"] * cfg["mlp_ratio"])


def _block_spec(p: str, dim: int, mlp: int) -> list:
    return [(f"{p}.norm1.weight", (dim,), "ones"), (f"{p}.norm1.bias", (dim,), "zeros"),
            (f"{p}.attn.qkv.weight", (3 * dim, dim), "fan_in"),
            (f"{p}.attn.qkv.bias", (3 * dim,), "zeros"),
            (f"{p}.attn.proj.weight", (dim, dim), "fan_in"),
            (f"{p}.attn.proj.bias", (dim,), "zeros"),
            (f"{p}.norm2.weight", (dim,), "ones"), (f"{p}.norm2.bias", (dim,), "zeros"),
            (f"{p}.mlp.fc1.weight", (mlp, dim), "fan_in"), (f"{p}.mlp.fc1.bias", (mlp,), "zeros"),
            (f"{p}.mlp.fc2.weight", (dim, mlp), "fan_in"), (f"{p}.mlp.fc2.bias", (dim,), "zeros")]


def _bn_spec(name: str, dim: int) -> list:
    return [(f"{name}.weight", (dim,), "ones"), (f"{name}.bias", (dim,), "zeros"),
            (f"{name}.running_mean", (dim,), "zeros"), (f"{name}.running_var", (dim,), "ones")]


def _branch(i: int) -> str:
    return f"_{i}" if i else ""


def spec(cfg: dict) -> list:
    """[(name, shape, init)]: ``fan_in``, ``ones``, ``zeros``, ``token``
    (truncated normal, std 0.02 at +-2 std) or ``classifier`` (normal, std
    0.001)."""
    dim, mlp, p = cfg["embed_dim"], _mlp(cfg), cfg["patch_size"]
    n_cls, branches = cfg.get("num_classes", 0), 1 + cfg["divide_length"]
    out = [("base.cls_token", (1, 1, dim), "token"),
           ("base.pos_embed", (1, tokens(cfg), dim), "token"),
           ("base.patch_embed.proj.weight", (dim, 3, p, p), "fan_in"),
           ("base.patch_embed.proj.bias", (dim,), "zeros")]
    for i in range(cfg["depth"] - 1):
        out += _block_spec(f"base.blocks.{i}", dim, mlp)
    for br in ("b1", "b2"):
        out += _block_spec(f"{br}.0", dim, mlp) + [(f"{br}.1.weight", (dim,), "ones"),
                                                   (f"{br}.1.bias", (dim,), "zeros")]
    for i in range(branches):
        out += _bn_spec("bottleneck" + _branch(i), dim)
    if n_cls:
        for i in range(branches):
            out.append((f"classifier{_branch(i)}.weight", (n_cls, dim), "classifier"))
    return out


def _ln(P, name, x):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], 1e-6)


def _linear(P, name, x, prec):
    return prec.grad(F.linear(prec(x), prec(P[f"{name}.weight"]), P[f"{name}.bias"]))


def _block(P, p, x, prec, heads, u1=None, u2=None, rate=0.0):
    b, n, dim = x.shape
    hd = dim // heads
    qkv = _linear(P, f"{p}.attn.qkv", _ln(P, f"{p}.norm1", x), prec)
    q, k, v = (t.reshape(b, n, heads, hd).transpose(1, 2) for t in qkv.split(dim, -1))
    att = torch.softmax(prec.grad(prec(q) @ prec(k).transpose(-2, -1)) * hd ** -0.5, dim=-1)
    y = prec.grad(prec(att) @ prec(v)).transpose(1, 2).reshape(b, n, dim)
    y = _linear(P, f"{p}.attn.proj", y, prec)
    keep = 1.0 - rate
    if u1 is not None:
        y = y / keep * (u1 < keep).float()
    x = x + y
    h = F.gelu(_linear(P, f"{p}.mlp.fc1", _ln(P, f"{p}.norm2", x), prec))
    y = _linear(P, f"{p}.mlp.fc2", h, prec)
    if u2 is not None:
        y = y / keep * (u2 < keep).float()
    return x + y


def _shuffle(cfg: dict, tokens_: torch.Tensor) -> torch.Tensor:
    shift, groups = cfg["shift_num"], cfg["shuffle_groups"]
    b, _, c = tokens_.shape
    x = torch.cat([tokens_[:, shift:], tokens_[:, 1:shift]], dim=1)
    if x.shape[1] % groups:
        x = torch.cat([x, x[:, -2:-1]], dim=1)
    n = x.shape[1]
    return x.reshape(b, groups, n // groups, c).transpose(1, 2).reshape(b, n, c)


def _bn(P, name, x, train):
    return F.batch_norm(x, P[f"{name}.running_mean"], P[f"{name}.running_var"],
                        P[f"{name}.weight"], P[f"{name}.bias"], training=train, momentum=0.1,
                        eps=1e-5)


def forward(cfg: dict, P: dict, x: torch.Tensor, train: bool = False,
            prec: Precision | None = None, generator: torch.Generator | None = None):
    """(B, 3, H, W) normalized float32 images → in eval mode the (B, (1 +
    divide) x dim) embedding ``[global, local_1/4, ..., local_4/4]``; in
    train mode with classes ``(scores, feats)``, the branch logits and the
    branch features before their necks."""
    prec = prec or Precision()
    dim, depth, heads, divide = (cfg["embed_dim"], cfg["depth"], cfg["num_heads"],
                                 cfg["divide_length"])
    n_cls = cfg.get("num_classes", 0)
    b = x.shape[0]
    t = prec.grad(F.conv2d(prec(x), prec(P["base.patch_embed.proj.weight"]),
                           P["base.patch_embed.proj.bias"], cfg["patch_stride"]))
    t = t.permute(0, 2, 3, 1).flatten(1, 2)
    t = torch.cat([P["base.cls_token"].expand(b, 1, dim), t], dim=1) + P["base.pos_embed"]
    for i in range(depth - 1):
        rate = cfg["drop_path_rate"] * i / (depth - 1)
        u1 = u2 = None
        if train and rate > 0.0:
            u1, u2 = (torch.rand((b, 1, 1), generator=generator, device=x.device)
                      for _ in range(2))
        if torch.is_grad_enabled():
            # recomputed in the backward, so that float32 activations fit
            t = checkpoint(_block, P, f"base.blocks.{i}", t, prec, heads, u1, u2, rate,
                           use_reentrant=False)
        else:
            t = _block(P, f"base.blocks.{i}", t, prec, heads, u1, u2, rate)
    glob = _ln(P, "b1.1", _block(P, "b1.0", t, prec, heads)[:, 0])
    rest = _shuffle(cfg, t)
    n = (t.shape[1] - 1) // divide
    locs = [_ln(P, "b2.1", _block(P, "b2.0", torch.cat([t[:, :1], rest[:, i * n:(i + 1) * n]],
                                                        dim=1), prec, heads)[:, 0])
            for i in range(divide)]
    feats = [glob] + locs
    necks = [_bn(P, "bottleneck" + _branch(i), f, train) for i, f in enumerate(feats)]
    if train and n_cls:
        scores = [prec.grad(F.linear(prec(nk), prec(P[f"classifier{_branch(i)}.weight"])))
                  for i, nk in enumerate(necks)]
        return scores, feats
    return torch.cat([glob] + [f / LOCAL_SCALE for f in locs], dim=1)


def flops(cfg: dict, train: bool = False) -> float:
    """Model FLOPs of one image's forward; in training with the classifiers."""
    h, w = cfg["img_size"]
    return models.transreid_jpm(h, w, cfg.get("num_classes", 0) if train else 0,
                                cfg["embed_dim"], cfg["depth"], _mlp(cfg), cfg["patch_size"],
                                cfg["patch_stride"], cfg["divide_length"])


def attention(cfg: dict) -> list:
    """K4's launches a forward: [(launches, tokens, heads, head dim)]: the
    trunk and the global block at N tokens, the shared JPM block once per
    local chunk of 1 + (N - 1) // divide."""
    n, heads = tokens(cfg), cfg["num_heads"]
    hd = cfg["embed_dim"] // heads
    return [(cfg["depth"], n, heads, hd),
            (cfg["divide_length"], 1 + (n - 1) // cfg["divide_length"], heads, hd)]
