"""ViT / TransReID backbone: overlapping patches, SIE, drop-path, BN neck.

Port of ``daliid_tpu/models/vit.py``: :func:`drop_path` (``:80-86``),
:class:`Mlp` (``:89-104``), :class:`Attention` (``:107-151``), :class:`Block`
(``:154-183``), :func:`resize_pos_embed` (``:186-196``), :class:`ViTReID`
(``:199-300``) and the factories of ``:303-334``. One configurable module
covers the torchvision-style ViT-B/16 (``patch_stride == patch_size``) and
TransReID's overlapping patches (``patch_stride < patch_size``) with SIE
camera/view embeddings added to every token.

Attention goes to ``torch.nn.functional.scaled_dot_product_attention`` by
default, the counterpart of the JAX package's ``jax.nn.dot_product_attention``;
``use_fused_attention=True`` (the JAX package's ``use_pallas_attention``)
routes it through the port's hand-written kernel K4
(:func:`daliid_tpu_torch.ops.flash_attention.flash_attention`), which reads
q, k and v as strided views of the fused qkv projection and writes the
(B, N, C) input of ``proj``.

Numerics follow flax modules built with ``dtype``: parameters stay f32 and
are cast to the compute dtype where they are used; LayerNorm (eps 1e-6)
computes its statistics in f32 and returns the compute dtype; GELU is the
exact erf form unless ``gelu_approx``. Stochastic depth draws its keep masks
from the ``generator`` passed to the train forward (the JAX package's
``droppath`` key cannot be replayed in torch). The activation checkpointing
of the JAX package (``remat``) is not ported.

``state_dict`` keys are the reference's TransReID keys under
``build_transformer``: ``base.cls_token``, ``base.pos_embed``,
``base.patch_embed.proj``, ``base.sie_embed``, ``base.blocks.{i}.norm1``,
``.attn.qkv``, ``.attn.proj``, ``.norm2``, ``.mlp.fc1``, ``.mlp.fc2``,
``base.norm`` and the BN neck ``bottleneck``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from daliid_tpu_torch.models.norm import TorchBatchNorm
from daliid_tpu_torch.models.resnet import Conv
from daliid_tpu_torch.ops.flash_attention import flash_attention


def drop_path(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Per-sample stochastic depth: keep each sample with probability
    ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``. The uniforms
    come from ``generator`` (on ``x``'s device)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=generator, device=x.device)
    return x / keep * (u < keep).to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` with f32 parameters that runs in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with f32 parameters, statistics and affine whose output is
    the input's dtype (flax ``nn.LayerNorm(dtype=...)``). A bf16 input is
    upcast first: CUDA's ``layer_norm`` refuses a bf16 input with f32
    weights."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, gelu_approx: bool = False):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.approximate = "tanh" if gelu_approx else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class Attention(nn.Module):
    """Multi-head self-attention over a fused qkv projection."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: float | None = None, use_fused_attention: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.qk_scale = qk_scale
        self.use_fused_attention = use_fused_attention
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.num_heads
        # (B, N, 3C) → three (B, N, H, hd) views, no copy
        q, k, v = (t.unflatten(-1, (self.num_heads, hd))
                   for t in self.qkv(x).split(c, dim=-1))
        if self.use_fused_attention:
            if self.qk_scale is not None:
                # the kernel applies hd^-1/2; fold the custom scale into q
                q = q * (self.qk_scale * hd ** 0.5)
            out = flash_attention(q, k, v)
        else:
            out = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=self.qk_scale,
            ).transpose(1, 2)
        return self.proj(out.reshape(b, n, c))


class Block(nn.Module):
    """Pre-norm transformer block with stochastic depth."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, qkv_bias: bool = True,
                 qk_scale: float | None = None, gelu_approx: bool = False,
                 use_fused_attention: bool = False):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias, qk_scale=qk_scale,
                              use_fused_attention=use_fused_attention)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), gelu_approx=gelu_approx)

    def _drop(self, y, generator):
        if self.training and self.drop_path_rate > 0.0:
            return drop_path(y, self.drop_path_rate, generator)
        return y

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + self._drop(self.attn(self.norm1(x)), generator)
        return x + self._drop(self.mlp(self.norm2(x)), generator)


def resize_pos_embed(pos_embed: np.ndarray, new_hw: tuple, old_hw: tuple) -> np.ndarray:
    """Bilinear grid interpolation of (1, 1 + H*W, C) position embeddings
    when loading a checkpoint at another resolution; antialiased when it
    shrinks, as ``jax.image.resize`` is."""
    pos = torch.as_tensor(np.asarray(pos_embed, np.float32))
    cls_tok, grid = pos[:, :1], pos[:, 1:]
    (oh, ow), (nh, nw) = old_hw, new_hw
    c = grid.shape[-1]
    grid = grid.reshape(1, oh, ow, c).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(nh, nw), mode="bilinear", align_corners=False,
                         antialias=True)
    grid = grid.permute(0, 2, 3, 1).reshape(1, nh * nw, c)
    return torch.cat([cls_tok, grid], dim=1).numpy()


class PatchEmbed(nn.Module):
    """The (overlapping) patch embedding, a strided convolution through
    ``proj``'s own forward, so that the int8 quantizer reaches it as it
    reaches the JAX package's ``patch_embed`` ``nn.Conv``."""

    def __init__(self, patch_size: int, patch_stride: int, embed_dim: int):
        super().__init__()
        self.proj = Conv(3, embed_dim, patch_size, stride=patch_stride, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x)
        return y.permute(0, 2, 3, 1).flatten(1, 2)  # (B, gh*gw, C), row-major grid


class VisionTransformer(nn.Module):
    """The trunk (the reference's ``vit_pytorch`` backbone): patch embedding,
    cls and position tokens, SIE, the blocks and, unless ``local_feature``,
    the final LayerNorm. ``forward`` → the token sequence (B, 1 + H*W, C) in
    the compute dtype, or, with ``local_feature``, in f32 before the last of
    ``depth`` blocks (the JPM trunk)."""

    def __init__(self, img_size=(256, 128), patch_size: int = 16, patch_stride: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.1, qkv_bias: bool = True,
                 qk_scale: float | None = None, gelu_approx: bool = False,
                 sie_cameras: int = 0, sie_views: int = 0, sie_coef: float = 1.5,
                 local_feature: bool = False, use_fused_attention: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.depth = depth
        self.sie_cameras, self.sie_views, self.sie_coef = sie_cameras, sie_views, sie_coef
        self.local_feature = local_feature
        self.grid_hw = ((img_size[0] - patch_size) // patch_stride + 1,
                        (img_size[1] - patch_size) // patch_stride + 1)
        self.patch_embed = PatchEmbed(patch_size, patch_stride, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + self.grid_hw[0] * self.grid_hw[1], embed_dim))
        if sie_cameras > 0 or sie_views > 0:
            n_sie = max(sie_cameras, 1) * max(sie_views, 1)
            self.sie_embed = nn.Parameter(torch.zeros(n_sie, 1, embed_dim))
        # linear drop-path schedule across depth (vit_pytorch.py:343-345)
        dprs = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
        run_depth = depth - 1 if local_feature else depth
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, dprs[i], qkv_bias=qkv_bias,
                  qk_scale=qk_scale, gelu_approx=gelu_approx,
                  use_fused_attention=use_fused_attention)
            for i in range(run_depth))
        if not local_feature:
            self.norm = LayerNorm(embed_dim)

    def forward(self, x, camera_ids=None, view_ids=None, generator=None) -> torch.Tensor:
        x = self.patch_embed(x.to(self.dtype))
        b, _, c = x.shape
        x = torch.cat([self.cls_token.to(self.dtype).expand(b, 1, c), x], dim=1)
        x = x + self.pos_embed.to(self.dtype)
        if self.sie_cameras > 0 or self.sie_views > 0:
            zeros = lambda: torch.zeros(b, dtype=torch.long, device=x.device)
            if self.sie_cameras > 0 and self.sie_views > 0:
                idx = camera_ids.long() * self.sie_views + view_ids.long()
            elif self.sie_cameras > 0:
                idx = camera_ids.long() if camera_ids is not None else zeros()
            else:
                idx = view_ids.long() if view_ids is not None else zeros()
            x = x + self.sie_coef * self.sie_embed[idx].to(self.dtype)
        for blk in self.blocks:
            x = blk(x, generator)
        if self.local_feature:
            return x.float()
        return self.norm(x)


class ViTReID(nn.Module):
    """ViT trunk + ReID head: ``forward(x, camera_ids)`` → (B, embed_dim) f32,
    the cls token after the final LayerNorm and an f32 BN neck."""

    def __init__(self, img_size=(256, 128), patch_size: int = 16, patch_stride: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.1, qkv_bias: bool = True,
                 qk_scale: float | None = None, gelu_approx: bool = False,
                 sie_cameras: int = 0, sie_views: int = 0, sie_coef: float = 1.5,
                 use_fused_attention: bool = False, dtype: torch.dtype = torch.float32):
        """``use_fused_attention`` is the JAX package's ``use_pallas_attention``:
        attention through the hand-written kernel K4 instead of PyTorch's
        ``scaled_dot_product_attention``."""
        super().__init__()
        self.dtype = dtype
        self.sie_cameras = sie_cameras
        self.feature_dim = embed_dim
        self.base = VisionTransformer(
            img_size, patch_size, patch_stride, embed_dim, depth, num_heads, mlp_ratio,
            drop_path_rate, qkv_bias, qk_scale, gelu_approx, sie_cameras, sie_views, sie_coef,
            local_feature=False, use_fused_attention=use_fused_attention, dtype=dtype)
        self.bottleneck = TorchBatchNorm(embed_dim, dtype=torch.float32)

    def forward(self, x, camera_ids=None, view_ids=None, generator=None) -> torch.Tensor:
        tokens = self.base(x, camera_ids, view_ids, generator)
        return self.bottleneck(tokens[:, 0].float())


def vit_base_reid(**kw) -> ViTReID:
    """ViT-B/16 ReID (vit_pytorch.py:453-460)."""
    return ViTReID(embed_dim=768, depth=12, num_heads=12, **kw)


def vit_small_reid(**kw) -> ViTReID:
    """The reference's ``vit_small`` (vit_pytorch.py:461-468): embed 768,
    depth 8, 8 heads, mlp_ratio 3, no qkv bias, qk_scale 768^-0.5."""
    return ViTReID(embed_dim=768, depth=8, num_heads=8, mlp_ratio=3.0, qkv_bias=False,
                   qk_scale=768 ** -0.5, **kw)


def deit_small_reid(**kw) -> ViTReID:
    """DeiT-small (vit_pytorch.py:470-476): embed 384, depth 12, 6 heads."""
    return ViTReID(embed_dim=384, depth=12, num_heads=6, **kw)


def transreid_base(img_size=(256, 128), sie_cameras: int = 0, sie_views: int = 0,
                   **kw) -> ViTReID:
    """TransReID ViT-B with overlapping stride-12 patches and SIE
    (make_models.py:121-218)."""
    return ViTReID(img_size=img_size, patch_stride=12, sie_cameras=sie_cameras,
                   sie_views=sie_views, **kw)

