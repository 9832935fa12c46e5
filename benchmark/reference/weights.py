"""Seeded weights for both sides of a check.

``make_weights(shapes, seed, device)`` draws every parameter of
``model.param_shapes`` from one ``torch.Generator`` on ``device`` in one
call, in float32 (the port keeps f32 parameters and computes in bf16):
matrices and conv kernels N(0, 1 / fan_in) with fan_in = numel / shape[0],
norm scales 1 + N(0, 0.05^2), biases N(0, 0.02^2), relative-position
tables N(0, 0.02^2), the query embedding N(0, 1). The heads are drawn too,
so no query ties with another at the first step.
"""

from __future__ import annotations

import math

import torch


def _scale_shift(name, shape):
    if name.endswith("relative_position_bias_table"):
        return 0.02, 0.0
    if name == "_query_embed.weight":
        return 1.0, 0.0
    if len(shape) == 1:
        is_norm = ".norm" in name or "._block.1." in name \
            or "._block.4." in name
        if name.endswith(".weight") and is_norm:
            return 0.05, 1.0
        return 0.02, 0.0
    fan_in = math.prod(shape) // shape[0]
    return 1.0 / math.sqrt(fan_in), 0.0


def make_weights(shapes: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        scale, shift = _scale_shift(name, shape)
        out[name] = (flat[at:at + n].view(shape) * scale + shift).clone()
        at += n
    return out
