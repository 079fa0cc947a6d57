"""Seeded weights, made on the device in a few large calls.

One ``torch.Generator`` on the device, seeded from the run's seed, fills
one flat normal tensor for every random leaf of a model's spec (the
reference's ``spec()``: name, shape, init), which is then cut into leaves
and scaled: ``fan_in`` ~ N(0, 1/fan in), ``token`` ~ N(0, 0.02) clipped at
two standard deviations, ``classifier`` ~ N(0, 0.001); ``ones`` and
``zeros`` are constants. Both the program and the reference are loaded
from the same tensors.
"""

from __future__ import annotations

import math

import torch


def make(spec: list, seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor} on ``device`` for ``spec``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    random = [(n, s, i) for n, s, i in spec if i not in ("ones", "zeros")]
    total = sum(math.prod(s) for _, s, _ in random)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape, init in spec:
        if init == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
            continue
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
            continue
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        if init == "fan_in":
            leaf.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        elif init == "token":
            leaf.clamp_(-2.0, 2.0).mul_(0.02)
        elif init == "classifier":
            leaf.mul_(0.001)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
        out[name] = leaf
    return out
