"""Int8 post-training quantization of the extraction path.

Port of ``daliid_tpu/ops/quantize.py``: symmetric per-tensor activation and
per-output-channel weight scales.

- :func:`calibrate` runs one forward with a forward pre-hook on every
  quantizable layer that records the absolute maximum of its input (in the
  layer's input dtype, as f32; a layer called several times, such as
  OSNet's shared channel gate, keeps the largest), as the JAX
  ``calibration_interceptor`` (``:113-126``) and ``calibrate``
  (``:140-163``) sow it. The keys are the port's module names.
- :func:`prepare` turns ``{name: absmax}`` into a plan: for each layer that
  will run in int8, its quantized weights, scales and bias, made once (the
  JAX package quantizes the weights inside every traced forward).
- :func:`quantized` is a context in which each planned layer's ``forward``
  is the int8 one (an instance attribute over the class's method, removed on
  exit); no PyTorch function is patched. :func:`quantized_apply` is one call
  of the model inside it (``:295-311``).

Which layers are convolutions and which are Dense layers follows the flax
module kinds of the JAX package, not the torch classes: :func:`quant_layers`
maps ``nn.Linear`` and the 1x1 convolutions that are ``nn.Dense`` layers in
flax (:class:`~daliid_tpu_torch.models.resnet.Dense1x1`: OSNet's channel
gate, EfficientNet's squeeze-excitation) to ``dense``, every other
``nn.Conv2d`` to ``conv``. The Dense rule keeps those gates in floating
point (their hidden widths are below ``dense_min_dim``), as in JAX.

Per layer (``make_quantized_interceptor``, ``:210-292``):

- conv: ``s_in = float32(absmax) / 127`` (an f32 division), the weights
  quantized per output channel with ``s_w = max(max|w| / 127, 1e-12)`` and
  packed once for the kernel (``pack_weights``); the layer's floating-point
  input goes to :func:`daliid_tpu_torch.ops.conv_int8.conv_int8` as it is,
  and the kernel quantizes it while loading it to the codes of
  ``clip(round(x / s_in), -127, 127)`` (a true f32 division, round half to
  even: ``conv_int8.quantize_sym``), the JAX
  ``_quantize_sym`` before the int8 convolution; then ``float32(acc) *
  (s_in * s_w)`` (the scales first), ``+ bias``, cast. No int8 copy of the
  input is written. A conv without a scale, with a scale <= 0, or
  ``skip``-ped stays in floating point. Dilation and padding modes other
  than zeros raise.
- dense (``_quantized_dense``, ``:175-207``): only when both widths are at
  least ``dense_min_dim`` (else floating point); a static per-tensor scale
  ``max(float32(absmax), 1e-12) / 127`` when calibrated with absmax > 0,
  else dynamic per-row scales ``max(max|x_row| / 127, 1e-12)``; per-column
  weight scales; the int32 product through ``torch._int_mm`` (cuBLASLt
  int8 on the GPU; the JAX package leaves this plain matrix product to XLA,
  outside any Pallas kernel), rows, depth and columns padded with zeros to
  what it takes and trimmed after; ``acc * s_in * s_w`` left to right,
  ``+ bias``, cast.

Every division by a scale is a tensor division on the input's device: on
CUDA, PyTorch turns a division by a host scalar into a multiplication by
its reciprocal, which can round differently. The result dtype is the one
the floating-point layer returns: the port's layers compute in their
input's dtype, and a plain torch layer takes its input in its weights'
dtype, so in both cases the input's (``_result_dtype``, ``:166-172``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from daliid_tpu_torch.models.resnet import Dense1x1
from daliid_tpu_torch.ops.conv_int8 import conv_int8, pack_weights, quantize_sym


def quant_layers(module: nn.Module) -> Dict[str, str]:
    """``{module name: 'conv' | 'dense'}`` for every layer the quantizer
    reaches, by its flax module kind."""
    out = {}
    for name, m in module.named_modules():
        if isinstance(m, (nn.Linear, Dense1x1)):
            out[name] = "dense"
        elif isinstance(m, nn.Conv2d):
            out[name] = "conv"
    return out


def _scalar(value: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(value), device=device)


def _channel_scales(w: torch.Tensor, dims) -> torch.Tensor:
    """Symmetric per-output-channel scales ``max(max|w| / 127, 1e-12)``."""
    s = w.abs().amax(dim=dims) / _scalar(127.0, w.device)
    return torch.clamp_min(s, np.float32(1e-12))


def conv_config(m: nn.Conv2d):
    """The convolution attributes the int8 path takes → (stride, padding,
    groups), the pairs (h, w) with symmetric padding; raise on anything else
    (``_conv_lax_config``, ``:78-105``)."""
    if any(d != 1 for d in m.dilation):
        raise NotImplementedError(f"int8 path: dilation={tuple(m.dilation)} unsupported")
    if m.padding_mode != "zeros" or isinstance(m.padding, str):
        raise NotImplementedError(f"int8 path: padding {m.padding!r} ({m.padding_mode}) "
                                  f"unsupported")
    return tuple(m.stride), tuple(m.padding), int(m.groups)


def calibrate(module: nn.Module, *args, **kwargs) -> Dict[str, float]:
    """One forward of ``module(*args, **kwargs)`` (under ``inference_mode``)
    → ``{layer name: input absmax}`` (host floats) of every layer of
    :func:`quant_layers` that ran."""
    stats: Dict[str, torch.Tensor] = {}
    handles = []

    def hook_for(name):
        def hook(_mod, inputs):
            a = inputs[0].detach().abs().amax().float()
            stats[name] = a if name not in stats else torch.maximum(stats[name], a)
        return hook

    mods = dict(module.named_modules())
    for name in quant_layers(module):
        handles.append(mods[name].register_forward_pre_hook(hook_for(name)))
    try:
        with torch.inference_mode():
            module(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    if not stats:
        return {}
    values = torch.stack(list(stats.values())).cpu().tolist()  # one transfer
    return dict(zip(stats, values))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm(a, b)``: int8 (m, k) x (k, n) → exact int32, on the
    GPU m > 16 and k, n multiples of 8. ``int8_matmul.calls`` counts the
    calls, so that a run can show its Dense layers went int8."""
    int8_matmul.calls += 1
    return torch._int_mm(a, b)


int8_matmul.calls = 0


class _QuantConv:
    """One conv in int8: weights quantized (and, on the card, packed for the
    kernel) once; the kernel quantizes the input in its loads."""

    def __init__(self, m: nn.Conv2d, absmax: float):
        self.stride, self.padding, self.groups = conv_config(m)
        w = m.weight.detach().float()
        self.s_in = float(np.float32(absmax) / np.float32(127.0))
        self.s_in_t = _scalar(self.s_in, w.device)
        self.s_w = _channel_scales(w, (1, 2, 3))
        self.wq = quantize_sym(w, self.s_w.view(-1, 1, 1, 1)).permute(0, 2, 3, 1).contiguous()
        self.w_packed = (pack_weights(self.wq, self.groups) if self.wq.device.type == "cuda"
                         else None)
        self.bias = None if m.bias is None else m.bias.detach().float()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return conv_int8(x, self.wq, self.stride, self.padding, self.groups, self.s_in,
                         self.s_w, self.bias, out_dtype=x.dtype, w_packed=self.w_packed)


class _QuantDense:
    """One Dense layer in int8 over its input's last axis (a ``Dense1x1``'s
    channel axis): static per-tensor or dynamic per-row input scales."""

    def __init__(self, m: nn.Module, absmax: float | None):
        w = m.weight.detach().float()
        w = w.reshape(w.shape[0], -1)  # (out, in); a Dense1x1's (O, C, 1, 1)
        self.conv = isinstance(m, nn.Conv2d)
        self.d_in, self.d_out = w.shape[1], w.shape[0]
        self.s_in_t = (None if absmax is None else
                       _scalar(np.maximum(np.float32(absmax), np.float32(1e-12))
                               / np.float32(127.0), w.device))
        self.c127 = _scalar(127.0, w.device)
        self.s_w = _channel_scales(w, 1)
        wq = quantize_sym(w, self.s_w.view(-1, 1))
        # torch._int_mm on CUDA: depth and columns multiples of 8, more than 16 rows
        self.k_pad, n_pad = _round_up(self.d_in, 8), _round_up(self.d_out, 8)
        self.wq_t = F.pad(wq, (0, self.k_pad - self.d_in, 0, n_pad - self.d_out)).t()
        self.bias = None if m.bias is None else m.bias.detach().float()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xl = x.permute(0, 2, 3, 1) if self.conv else x
        lead = xl.shape[:-1]
        rows = xl.reshape(-1, self.d_in)
        if self.s_in_t is None:  # dynamic: one scale per row
            s_in = torch.clamp_min(rows.float().abs().amax(dim=1, keepdim=True)
                                   / self.c127, np.float32(1e-12))
        else:
            s_in = self.s_in_t
        xq = quantize_sym(rows, s_in)
        m = xq.shape[0]
        m_pad = max(_round_up(m, 8), 24)
        acc = int8_matmul(F.pad(xq, (0, self.k_pad - self.d_in, 0, m_pad - m)),
                          self.wq_t)[:m, :self.d_out]
        out = acc.float() * s_in * self.s_w
        if self.bias is not None:
            out = out + self.bias
        out = out.to(x.dtype).reshape(*lead, self.d_out)
        if self.conv:
            return out.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return out


def prepare(module: nn.Module, scales: Dict[str, float],
            skip: Callable[[str], bool] | None = None, dense: bool = True,
            dense_min_dim: int = 128) -> Dict[str, Callable]:
    """The int8 plan of ``module`` under ``scales``: ``{layer name: its int8
    forward}`` for every layer that runs in int8 (the others stay out and
    run in floating point). ``skip(name) -> True`` keeps a layer in floating
    point."""
    mods = dict(module.named_modules())
    plan: Dict[str, Callable] = {}
    for name, kind in quant_layers(module).items():
        if skip is not None and skip(name):
            continue
        m = mods[name]
        absmax = scales.get(name)
        degenerate = absmax is not None and float(absmax) <= 0.0
        if kind == "dense":
            d_out = m.weight.shape[0]
            d_in = math.prod(m.weight.shape[1:])
            if dense and d_in >= dense_min_dim and d_out >= dense_min_dim:
                plan[name] = _QuantDense(m, None if degenerate else absmax)
        elif absmax is not None and not degenerate:
            plan[name] = _QuantConv(m, absmax)
    return plan


@contextlib.contextmanager
def quantized(module: nn.Module, plan: Dict[str, Callable]):
    """Within the context, every layer of ``plan`` runs its int8 forward.
    One module must not run inside two such contexts at once."""
    mods = dict(module.named_modules())
    for name, fwd in plan.items():
        mods[name].forward = fwd
    try:
        yield module
    finally:
        for name in plan:
            del mods[name].forward


def quantized_apply(module: nn.Module, scales: Dict[str, float], *args,
                    skip: Callable[[str], bool] | None = None, dense: bool = True,
                    dense_min_dim: int = 128, **kwargs):
    """``module(*args, **kwargs)`` under ``inference_mode`` with every
    calibrated conv (and, by default, every Dense layer of at least
    ``dense_min_dim`` on both sides) in int8."""
    plan = prepare(module, scales, skip=skip, dense=dense, dense_min_dim=dense_min_dim)
    with torch.inference_mode(), quantized(module, plan):
        return module(*args, **kwargs)
