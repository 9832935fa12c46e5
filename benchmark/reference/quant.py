"""Rounding of the control: the reference computed one precision below
the configuration's bf16, in fp8 with a scale per tensor (e4m3 for the
forward operands, e5m2 for the gradients flowing back through them), as a
change that moved the model's products to fp8 would compute them."""

from __future__ import annotations

import torch

_E4M3, _E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def _round(t, dtype):
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / torch.finfo(dtype).max, 1.0)
    return ((t.float() / scale).to(dtype).float() * scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, _E4M3)

    @staticmethod
    def backward(ctx, g):
        return _round(g, _E5M2)


def fp8(t):
    """``t`` rounded to fp8 (e4m3) at its own scale; its gradient to e5m2."""
    return _Fp8.apply(t)
