"""Model FLOPs of one forward pass of one image, for the ``mfu`` metrics.

Two FLOPs per multiply-accumulate of every convolution and matrix product,
attention's QK^T and AV included; normalization, activation, pooling and the
losses are not counted. A training step counts three forwards; mining and
extraction one. Recompute and padding rows are not counted. Each model's
reference module (``benchmark/reference/``) calls its counter here with the
widths its configuration states.
"""

from __future__ import annotations


def _conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def resnet_reid(h: int, w: int, stages: list, expansion: int) -> float:
    """A bottleneck ResNet re-ID encoder: the 7x7 stem at the first stage's
    planes, then ``stages`` [(blocks, planes, stride)]."""
    macs = 0
    stem = stages[0][1]
    h, w = _conv_out(h, 7, 2, 3), _conv_out(w, 7, 2, 3)
    macs += h * w * stem * 3 * 49
    h, w = _conv_out(h, 3, 2, 1), _conv_out(w, 3, 2, 1)
    cin = stem
    for n_blocks, planes, stride in stages:
        for b in range(n_blocks):
            s = stride if b == 0 else 1
            macs += h * w * planes * cin                      # 1x1 in
            ho, wo = _conv_out(h, 3, s, 1), _conv_out(w, 3, s, 1)
            macs += ho * wo * planes * planes * 9             # 3x3
            macs += ho * wo * planes * expansion * planes     # 1x1 out
            if b == 0:
                macs += ho * wo * planes * expansion * cin    # projection shortcut
            h, w, cin = ho, wo, planes * expansion
    return 2.0 * macs


def _block(n: int, dim: int, mlp: int) -> int:
    return n * (3 * dim * dim + dim * dim + 2 * dim * mlp) + 2 * n * n * dim


def transreid_jpm(h: int, w: int, num_classes: int, dim: int, depth: int, mlp: int,
                  patch: int, stride: int, divide: int) -> float:
    """TransReID-JPM: the patch embedding, depth - 1 trunk blocks and the
    global block at N tokens, the shared JPM block once per local chunk of
    1 + (N - 1) // divide tokens, and with classes the 1 + divide
    classifiers."""
    gh, gw = (h - patch) // stride + 1, (w - patch) // stride + 1
    n = 1 + gh * gw
    macs = gh * gw * dim * 3 * patch * patch
    macs += depth * _block(n, dim, mlp)
    macs += divide * _block(1 + (n - 1) // divide, dim, mlp)
    macs += (1 + divide) * dim * num_classes
    return 2.0 * macs
