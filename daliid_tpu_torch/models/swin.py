"""Swin Transformer as a re-ID encoder: shifted-window attention with a
learned relative-position bias, a hierarchy of four widths, a BN neck.

Liu et al., *Swin Transformer*, ICCV 2021 (arXiv:2103.14030), as the re-ID
and detection codebases run it at 384x128 (SOLIDER, Chen et al., CVPR 2023,
arXiv:2303.17602, without its semantic controller). The JAX package has no
such model: ``swin_base`` exists only in the port (``PORT_ONLY_MODELS`` in
:mod:`daliid_tpu_torch.models.factory`), and every path that converts to or
from the JAX package's layout refuses it.

- Patch embedding: a 4x4 convolution at stride 4, 3 → C, then LayerNorm;
  no absolute position embedding.
- Stages i = 0..3 of width C·2^i, ``depths`` blocks and ``num_heads``
  heads each, window M; blocks alternate between shift 0 and ``shift_size``.
  Patch merging after every stage but the last: ``x[0::2, 0::2]``,
  ``x[1::2, 0::2]``, ``x[0::2, 1::2]``, ``x[1::2, 1::2]`` concatenated (the
  original's order), LayerNorm(4C), Linear(4C → 2C, no bias).
- Block (pre-norm): ``x + DropPath(WMSA(LN1(x)))``, then
  ``x + DropPath(MLP(LN2(x)))``, the MLP ``mlp_ratio``·C wide with exact
  GELU (tanh with ``gelu_approx``); stochastic depth rises linearly from 0
  to ``drop_path_rate`` over all the blocks.
- WMSA (mmdet's ``ShiftWindowMSA`` padding rule, not the classification
  code's window clip): the normed (B, H, W, C) grid is zero-padded right
  and bottom to multiples of M (the padded zeros stay in as keys), rolled by
  (-s, -s) where shifted, and cut into M x M windows, batch row
  ``b · nW + (wh · nWw + ww)``; qkv with bias, scale ``head_dim^-1/2``,
  plus ``table[idx]`` with ``idx[n, m] = (r_n - r_m + M - 1)(2M - 1) + (c_n
  - c_m + M - 1)``, plus in a shifted block -100 between tokens of different
  regions of the slices ``[0, Hp - M)``, ``[Hp - M, Hp - s)``, ``[Hp - s,
  Hp)`` (and the same on W); softmax, times V, the projection, the
  partition reversed, rolled back and cropped to H, W.
- Head: LayerNorm on the last stage, the mean over its real tokens, an f32
  BN neck; ``forward(x, camera_ids, view_ids, generator)`` → (B, 8C) f32,
  as :class:`~daliid_tpu_torch.models.vit.ViTReID`'s.

The bias is one additive operand a block call, built from the table
through autograd so that the table's gradient flows: (1, heads, N, N) in an
unshifted block, where every window takes the same, and (nW, heads, N, N)
with the shift mask in a shifted one. The route follows from what the
call can see: where the port's biased attention kernel takes q (bf16 on a
CUDA device, head dim 32, at most 64 tokens a window:
:func:`~daliid_tpu_torch.ops.flash_attention.bias_kernel_takes`), the bias
goes with q, k and v (strided views of the qkv projection) to
:func:`~daliid_tpu_torch.ops.flash_attention.flash_attention`; anywhere else
:func:`window_sdpa` gives it to ``scaled_dot_product_attention`` as a float
``attn_mask``.

``remat`` (:data:`~daliid_tpu_torch.models.vit.REMAT_MODES`) checkpoints each
block as the ViT's blocks are: ``full`` keeps only block inputs (attention
runs again in the backward), ``tuned`` keeps qkv, the attention output and
norm2's output, recomputing norm1 with the pad, roll and partition, the
projection with the reverse, the residual and norm2, and fc1 with GELU.
Drop path's uniforms are drawn before any checkpointed region. Every mode
gives the same values and gradients as ``none``.

Numerics follow the ViT's: f32 parameters cast to the compute dtype where
they are used, LayerNorm statistics in f32 (eps 1e-5, ``nn.LayerNorm``'s
default in the original code), the bias in f32.

``state_dict`` keys are the original's: ``patch_embed.proj``,
``patch_embed.norm``, ``layers.{i}.blocks.{j}.norm1``, ``.attn.qkv``,
``.attn.relative_position_bias_table``, ``.attn.proj``, ``.norm2``,
``.mlp.fc1``, ``.mlp.fc2``, ``layers.{i}.downsample.norm``,
``layers.{i}.downsample.reduction``, ``norm``, and the neck ``bottleneck``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from daliid_tpu_torch.models.norm import TorchBatchNorm
from daliid_tpu_torch.models.resnet import Conv
from daliid_tpu_torch.models.vit import (
    _CHECKPOINT,
    LayerNorm,
    Linear,
    Mlp,
    check_remat,
    drop_path,
    drop_path_uniforms,
)
from daliid_tpu_torch.ops.flash_attention import bias_kernel_takes, flash_attention

LN_EPS = 1e-5
MASK_VALUE = -100.0


def relative_position_index(window: int) -> torch.Tensor:
    """(M², M²) indices into the ((2M - 1)², heads) bias table."""
    r, c = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
    r, c = r.flatten(), c.flatten()
    return (r[:, None] - r[None, :] + window - 1) * (2 * window - 1) + (c[:, None] - c[None, :]
                                                                       + window - 1)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, Hp, Wp, C) → (B · nW, M², C), row ``b · nW + wh · nWw + ww``."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`: → (B, Hp, Wp, C)."""
    c = x.shape[-1]
    x = x.view(-1, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def shift_mask(hp: int, wp: int, window: int, shift: int, device=None) -> torch.Tensor:
    """(nW, M², M²) f32: -100 between tokens of a window that come from
    different regions of the cyclically shifted grid, else 0."""
    region = torch.zeros(1, hp, wp, 1, device=device)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    n = 0
    for hs in cuts:
        for ws in cuts:
            region[:, hs, ws, :] = n
            n += 1
    ids = window_partition(region, window).squeeze(-1)
    return (ids[:, None, :] != ids[:, :, None]).float() * MASK_VALUE


def window_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T D^-1/2 + bias[b % G]) v`` for (B, N, H, D) q, k, v and
    a (G, H, N, N) bias as one 4-d ``scaled_dot_product_attention`` call:
    the windows of an image go beside the heads, (B/G, G·H, N, D), so the
    mask (1, G·H, N, N) broadcasts over the images alone. → (B, N, H, D)."""
    b, n, h, d = q.shape
    g = bias.shape[0]
    q, k, v = (t.unflatten(0, (b // g, g)).permute(0, 1, 3, 2, 4).flatten(1, 2)
               for t in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v,
                                         attn_mask=bias.to(q.dtype).flatten(0, 1).unsqueeze(0))
    return out.unflatten(1, (g, h)).permute(0, 1, 3, 2, 4).flatten(0, 1)


class WindowAttention(nn.Module):
    """Multi-head attention within windows, over a fused qkv projection, with
    the relative-position bias table."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", relative_position_index(window),
                             persistent=False)

    def bias(self, mask: torch.Tensor | None) -> torch.Tensor:
        """The additive f32 operand: (1, heads, N, N), or with the shift
        ``mask`` (nW, N, N) → (nW, heads, N, N)."""
        n = self.window ** 2
        table = self.relative_position_bias_table[self.relative_position_index.view(-1)]
        bias = table.view(n, n, self.num_heads).permute(2, 0, 1).unsqueeze(0)
        return bias if mask is None else bias + mask.unsqueeze(1)

    def attend(self, qkv: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """Attention of the fused (B·nW, N, 3C) projection with ``bias``
        → (B·nW, N, C), the input of ``proj``."""
        b, n, c3 = qkv.shape
        c = c3 // 3
        hd = c // self.num_heads
        q, k, v = (t.unflatten(-1, (self.num_heads, hd)) for t in qkv.split(c, dim=-1))
        attend = flash_attention if bias_kernel_takes(q) else window_sdpa
        return attend(q, k, v, bias).reshape(b, n, c)


class SwinBlock(nn.Module):
    """Pre-norm shifted-window block with stochastic depth, checkpointed per
    ``remat`` when gradients are recorded."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.0,
                 gelu_approx: bool = False, remat: str = "none"):
        super().__init__()
        self.window, self.shift = window, shift
        self.drop_path_rate = drop_path_rate
        self.remat = check_remat(remat)
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu_approx=gelu_approx)

    def _drop(self, y, u):
        return y if u is None else drop_path(y, self.drop_path_rate, None, u)

    def _pad(self, h: int, w: int) -> tuple:
        m = self.window
        return -(-h // m) * m, -(-w // m) * m

    def _qkv(self, x, hw):
        """norm1, the zero pad, the roll and the partition, then qkv."""
        (h, w), (hp, wp) = hw, self._pad(*hw)
        b, _, c = x.shape
        x = F.pad(self.norm1(x).view(b, h, w, c), (0, 0, 0, wp - w, 0, hp - h))
        if self.shift:
            x = torch.roll(x, (-self.shift, -self.shift), (1, 2))
        return self.attn.qkv(window_partition(x, self.window))

    def _proj_norm2(self, x, attn_out, u1, hw):
        """proj, the partition reversed, rolled back and cropped, the
        residual, then norm2."""
        (h, w), (hp, wp) = hw, self._pad(*hw)
        b, l, c = x.shape
        y = window_reverse(self.attn.proj(attn_out), self.window, hp, wp)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), (1, 2))
        x = x + self._drop(y[:, :h, :w].reshape(b, l, c), u1)
        return x, self.norm2(x)

    def _block(self, x, bias, u1, u2, hw):
        x, n2 = self._proj_norm2(x, self.attn.attend(self._qkv(x, hw), bias), u1, hw)
        return x + self._drop(self.mlp(n2), u2)

    def forward(self, x: torch.Tensor, hw: tuple, mask: torch.Tensor | None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, H·W, C) tokens of the (H, W) grid ``hw``; ``mask`` the
        stage's shift mask (used where this block is shifted)."""
        u1 = u2 = None
        if self.training and self.drop_path_rate > 0.0:
            u1, u2 = drop_path_uniforms(x, generator), drop_path_uniforms(x, generator)
        bias = self.attn.bias(mask if self.shift else None)
        if self.remat == "none" or not torch.is_grad_enabled():
            return self._block(x, bias, u1, u2, hw)
        if self.remat == "full":
            return checkpoint(self._block, x, bias, u1, u2, hw, **_CHECKPOINT)
        qkv = checkpoint(self._qkv, x, hw, **_CHECKPOINT)
        x, n2 = checkpoint(self._proj_norm2, x, self.attn.attend(qkv, bias), u1, hw,
                           **_CHECKPOINT)
        return x + self._drop(checkpoint(self.mlp, n2, **_CHECKPOINT), u2)


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated in the original's order, LayerNorm(4C),
    Linear(4C → 2C, no bias); an odd side is zero-padded first."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, hw: tuple) -> tuple:
        h, w = hw
        b, _, c = x.shape
        x = F.pad(x.view(b, h, w, c), (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        hw = x.shape[1], x.shape[2]
        return self.reduction(self.norm(x.flatten(1, 2))), hw


class SwinStage(nn.Module):
    """The blocks of one width, then (but in the last stage) patch
    merging. The stage's shift mask is made once for each grid and device."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float, drop_path_rates, downsample: bool, gelu_approx: bool,
                 remat: str):
        super().__init__()
        self.window, self.shift = window, shift
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window, shift if i % 2 else 0, mlp_ratio,
                      drop_path_rates[i], gelu_approx, remat)
            for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None
        self._masks: dict = {}

    def mask(self, hw: tuple, device) -> torch.Tensor | None:
        if not self.shift or len(self.blocks) < 2:
            return None
        m = self.window
        key = (-(-hw[0] // m) * m, -(-hw[1] // m) * m, str(device))
        if key not in self._masks:
            self._masks[key] = shift_mask(key[0], key[1], m, self.shift, device)
        return self._masks[key]

    def forward(self, x, hw, generator=None):
        mask = self.mask(hw, x.device)
        for blk in self.blocks:
            x = blk(x, hw, mask, generator)
        if self.downsample is not None:
            x, hw = self.downsample(x, hw)
        return x, hw


class PatchEmbed(nn.Module):
    """The 4x4 / 4 patch convolution, then LayerNorm → (B, H/4 · W/4, C)."""

    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = Conv(3, embed_dim, patch_size, stride=patch_size, bias=True)
        self.norm = LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> tuple:
        y = self.proj(x)
        hw = y.shape[2], y.shape[3]
        return self.norm(y.permute(0, 2, 3, 1).flatten(1, 2)), hw


class SwinReID(nn.Module):
    """Swin trunk + re-ID head: ``forward(x, camera_ids, view_ids,
    generator)`` → (B, embed_dim · 2^(stages - 1)) f32, the mean of the last
    stage's normed tokens through an f32 BN neck."""

    def __init__(self, img_size=(384, 128), patch_size: int = 4, embed_dim: int = 128,
                 depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32), window_size: int = 7,
                 shift_size: int = 3, mlp_ratio: float = 4.0, drop_path_rate: float = 0.1,
                 gelu_approx: bool = False, remat: str = "none",
                 dtype: torch.dtype = torch.float32):
        """``gelu_approx``: the MLPs' GELU in its tanh form; ``remat`` one of
        ``REMAT_MODES``. ``img_size`` is taken for the
        factories' signature: the model takes any input size."""
        super().__init__()
        depths, num_heads = tuple(depths), tuple(num_heads)
        if len(depths) != len(num_heads):
            raise ValueError(f"depths {depths} and num_heads {num_heads} must have one entry "
                             f"a stage")
        check_remat(remat)
        self.dtype = dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.layers = nn.ModuleList()
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            first = sum(depths[:i])
            self.layers.append(SwinStage(
                embed_dim * 2 ** i, depth, heads, window_size, shift_size, mlp_ratio,
                rates[first:first + depth], i + 1 < len(depths), gelu_approx, remat))
        self.feature_dim = embed_dim * 2 ** (len(depths) - 1)
        self.norm = LayerNorm(self.feature_dim, eps=LN_EPS)
        self.bottleneck = TorchBatchNorm(self.feature_dim, dtype=torch.float32)

    def forward(self, x, camera_ids=None, view_ids=None, generator=None) -> torch.Tensor:
        x, hw = self.patch_embed(x.to(self.dtype))
        for stage in self.layers:
            x, hw = stage(x, hw, generator)
        return self.bottleneck(self.norm(x).float().mean(dim=1))


def swin_base_reid(**kw) -> SwinReID:
    """Swin-B (arXiv:2103.14030, Table 1): C 128, depths (2, 2, 18, 2),
    heads (4, 8, 16, 32), window 7."""
    return SwinReID(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                    window_size=7, **kw)
