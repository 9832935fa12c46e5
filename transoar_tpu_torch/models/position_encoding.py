"""3D positional encodings (port of
``transoar_tpu/models/position_encoding.py``).

Sine: per axis ``2 * ceil(C / 6)`` channels laid out block-wise
``[sin(p0), sin(p2), ..., cos(p1), cos(p3), ...]`` over a normalized
half-offset grid, channel order (y, x, z), truncated to C channels —
reference position_encoding.py:10-51. Learned (``pos_encoding: learned``):
three ``[50, 2 * ceil(C / 6)]`` tables, U[0, 1) at init, named as the
reference's ``row_embed`` (axis 0), ``col_embed`` (axis 1) and
``depth_embed`` (axis 2), broadcast over the grid in the channel-block
order col, row, depth, truncated to C (reference
position_encoding.py:54-86). Channels-last ``[S0, S1, S2, C]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn


def sine_position_encoding(spatial_shape, channels, temperature=10000.0,
                           scale=2 * math.pi) -> np.ndarray:
    """The [S0, S1, S2, C] sine table (float64) for a static spatial shape."""
    per_axis = int(np.ceil(channels / 6) * 2)

    dim_t = np.arange(per_axis, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / per_axis)

    def axis_embed(size):
        grid = (np.arange(size, dtype=np.float64) + 0.5) / size * scale
        pos = grid[:, None] / dim_t[None, :]
        return np.concatenate([np.sin(pos[:, 0::2]), np.cos(pos[:, 1::2])],
                              axis=-1)

    s0, s1, s2 = spatial_shape
    pos_x = axis_embed(s0)[:, None, None, :]  # varies along axis 0
    pos_y = axis_embed(s1)[None, :, None, :]  # varies along axis 1
    pos_z = axis_embed(s2)[None, None, :, :]  # varies along axis 2
    zeros = np.zeros((s0, s1, s2, per_axis))
    pos = np.concatenate([pos_y + zeros, pos_x + zeros, pos_z + zeros],
                         axis=-1)
    return pos[..., :channels]


class PositionEmbeddingSine3D(nn.Module):
    """x [B, S0, S1, S2, C] -> the sine table [B, S0, S1, S2, C] in
    ``dtype``, built once per (shape, device) and kept."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.channels = channels
        self.dtype = dtype
        self._tables: dict = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        key = (tuple(x.shape[1:4]), x.device)
        table = self._tables.get(key)
        if table is None:
            # a normal tensor even when first built under inference_mode, so
            # that a later training forward may save it for the backward
            with torch.inference_mode(False):
                table = torch.as_tensor(
                    sine_position_encoding(key[0], self.channels),
                    dtype=self.dtype, device=x.device)
            self._tables[key] = table
        return table.expand(x.shape[0], *table.shape)


class _Table(nn.Module):
    """One learned axis table ``weight`` [positions, channels], U[0, 1) at
    init (flax ``uniform(scale=1.0)``)."""

    def __init__(self, positions: int, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(positions, channels))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.uniform_(0.0, 1.0, generator=generator)


class PositionEmbeddingLearned3D(nn.Module):
    """x [B, S0, S1, S2, C] -> the learned tables outer-summed over the
    grid, [B, S0, S1, S2, C] in ``dtype``."""

    def __init__(self, channels: int, max_positions: int = 50,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.channels = channels
        self.dtype = dtype
        per_axis = int(np.ceil(channels / 6) * 2)
        self.row_embed = _Table(max_positions, per_axis)
        self.col_embed = _Table(max_positions, per_axis)
        self.depth_embed = _Table(max_positions, per_axis)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s0, s1, s2 = x.shape[1:4]
        e0 = self.row_embed.weight[:s0][:, None, None, :]
        e1 = self.col_embed.weight[:s1][None, :, None, :]
        e2 = self.depth_embed.weight[:s2][None, None, :, :]
        shape = (s0, s1, s2, e0.shape[-1])
        pos = torch.cat([e1.expand(shape), e0.expand(shape),
                         e2.expand(shape)], dim=-1)
        pos = pos[..., :self.channels].to(self.dtype)
        return pos.expand(x.shape[0], *pos.shape)


def build_pos_enc(kind: str, channels: int,
                  dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    if kind == "sine":
        return PositionEmbeddingSine3D(channels, dtype)
    if kind == "learned":
        return PositionEmbeddingLearned3D(channels, dtype=dtype)
    raise ValueError(f"unknown positional encoding: {kind}")
