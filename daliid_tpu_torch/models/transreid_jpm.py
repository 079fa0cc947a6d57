"""TransReID with the Jigsaw Patch Module (JPM).

Port of ``daliid_tpu/models/transreid_jpm.py``: :func:`shuffle_unit`
(``:28-42``) and :class:`TransReIDJPM` (``:45-163``), the reference's
``build_transformer_local`` (``Person-ReID/make_models.py:221-389``):

- the trunk: the overlapping-patch ViT run to depth - 1, returning the f32
  token sequence (``VisionTransformer(local_feature=True)``);
- the global branch ``b1``: one transformer block and a LayerNorm, whose
  cls token is the global feature;
- the JPM branch: patch shift and group shuffle, then ``divide_length``
  chunks of ``(N - 1) // divide_length`` tokens (tokens left over are
  dropped), each behind the cls token, through one shared block ``b2``;
- 5 f32 BN necks; with ``num_classes`` a bias-free classifier per branch
  (init normal(0.001)).

Train mode with ``num_classes`` returns ``(scores, feats)``: the 5 branch
logits (or, for a margin ``id_loss_type`` with labels, the margin logits of
the global post-neck feature alone) and the 5 pre-neck features. Otherwise
it returns ``concat([global, local_1/4, ..., local_4/4])``, before or after
the necks per ``neck_feat``; the necks run in every mode, so train mode
updates their running statistics either way, as in the JAX package.

``state_dict`` keys are the reference's: ``base.*`` (trunk blocks
``0 .. depth-2``), ``b1.0.*`` / ``b1.1.*``, ``b2.0.*`` / ``b2.1.*``,
``bottleneck``, ``bottleneck_1..4``, ``classifier``, ``classifier_1..4``.
"""

from __future__ import annotations

import torch
from torch import nn

from daliid_tpu_torch.margins import margin_logits
from daliid_tpu_torch.models.norm import TorchBatchNorm
from daliid_tpu_torch.models.vit import Block, LayerNorm, VisionTransformer


def shuffle_unit(features: torch.Tensor, shift: int, group: int, begin: int = 1) -> torch.Tensor:
    """Patch shift and group shuffle over (B, N, C) tokens, the cls token at
    index 0 dropped (``make_models.py:8-25``). A token count that ``group``
    does not divide is padded with a copy of the second-to-last token."""
    b, _, c = features.shape
    x = torch.cat([features[:, begin - 1 + shift:], features[:, begin:begin - 1 + shift]], dim=1)
    n = x.shape[1]
    if n % group != 0:
        x = torch.cat([x, x[:, -2:-1]], dim=1)
        n = x.shape[1]
    return x.reshape(b, group, n // group, c).transpose(1, 2).reshape(b, n, c)


class TransReIDJPM(nn.Module):
    """TransReID + JPM: ``forward(x, camera_ids, view_ids, labels,
    generator)``; ``generator`` draws the trunk's stochastic depth."""

    def __init__(self, img_size=(256, 128), patch_size: int = 16, patch_stride: int = 12,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.1, sie_cameras: int = 0,
                 sie_views: int = 0, sie_coef: float = 1.5, num_classes: int = 0,
                 divide_length: int = 4, shift_num: int = 5, shuffle_groups: int = 2,
                 rearrange: bool = True, neck_feat: str = "before",
                 id_loss_type: str = "softmax", margin_s: float | None = None,
                 margin_m: float | None = None, gelu_approx: bool = False,
                 use_fused_attention: bool = False, dtype: torch.dtype = torch.float32):
        """``use_fused_attention`` is the JAX package's ``use_pallas_attention``:
        every block's attention through the hand-written kernel K4."""
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.divide_length, self.shift_num = divide_length, shift_num
        self.shuffle_groups, self.rearrange = shuffle_groups, rearrange
        self.neck_feat, self.id_loss_type = neck_feat, id_loss_type
        self.margin_kw = {k: v for k, v in (("s", margin_s), ("m", margin_m)) if v is not None}
        self.feature_dim = 5 * embed_dim
        self.base = VisionTransformer(
            img_size, patch_size, patch_stride, embed_dim, depth, num_heads, mlp_ratio,
            drop_path_rate, gelu_approx=gelu_approx, sie_cameras=sie_cameras,
            sie_views=sie_views, sie_coef=sie_coef, local_feature=True,
            use_fused_attention=use_fused_attention, dtype=dtype)

        def branch():
            return nn.Sequential(
                Block(embed_dim, num_heads, mlp_ratio, 0.0, gelu_approx=gelu_approx,
                      use_fused_attention=use_fused_attention),
                LayerNorm(embed_dim))

        self.b1 = branch()
        self.b2 = branch()  # shared across the local chunks (make_models.py:333-348)
        self.bottleneck = TorchBatchNorm(embed_dim, dtype=torch.float32)
        for i in range(1, 5):
            self.add_module(f"bottleneck_{i}", TorchBatchNorm(embed_dim, dtype=torch.float32))
        if num_classes:
            self.classifier = nn.Linear(embed_dim, num_classes, bias=False)
            for i in range(1, 5):
                self.add_module(f"classifier_{i}", nn.Linear(embed_dim, num_classes, bias=False))

    def _branch_cls(self, branch: nn.Sequential, tokens: torch.Tensor) -> torch.Tensor:
        """Block, then the LayerNorm of the cls token alone (it normalizes
        each token by itself), → f32."""
        return branch[1](branch[0](tokens.to(self.dtype))[:, 0]).float()

    def forward(self, x, camera_ids=None, view_ids=None, labels=None, generator=None):
        tokens = self.base(x, camera_ids, view_ids, generator)
        global_feat = self._branch_cls(self.b1, tokens)
        patch_length = (tokens.shape[1] - 1) // self.divide_length
        cls = tokens[:, :1]
        rest = (shuffle_unit(tokens, self.shift_num, self.shuffle_groups) if self.rearrange
                else tokens[:, 1:])
        locals_ = [
            self._branch_cls(self.b2, torch.cat(
                [cls, rest[:, i * patch_length:(i + 1) * patch_length]], dim=1))
            for i in range(self.divide_length)
        ]
        feat = self.bottleneck(global_feat)
        local_bns = [getattr(self, f"bottleneck_{i + 1}")(lf) for i, lf in enumerate(locals_)]
        if self.num_classes and self.training:
            if self.id_loss_type != "softmax" and labels is not None:
                # the margin head takes the global post-neck feature only
                # (classifier(feat, label), make_models.py:361-363)
                scores = [margin_logits(self.id_loss_type, feat, self.classifier.weight.T,
                                        labels, **self.margin_kw)]
            else:
                scores = [self.classifier(feat)] + [
                    getattr(self, f"classifier_{i + 1}")(lbn) for i, lbn in enumerate(local_bns)]
            return scores, [global_feat] + locals_
        if self.neck_feat == "after":
            parts = [feat] + [lbn / 4.0 for lbn in local_bns]
        else:
            parts = [global_feat] + [lf / 4.0 for lf in locals_]
        return torch.cat(parts, dim=1)
