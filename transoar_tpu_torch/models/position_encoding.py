"""3D sine positional encoding (port of
``transoar_tpu/models/position_encoding.py``, sine path).

Per axis ``2 * ceil(C / 6)`` channels laid out block-wise
``[sin(p0), sin(p2), ..., cos(p1), cos(p3), ...]`` over a normalized
half-offset grid, channel order (y, x, z), truncated to C channels —
reference position_encoding.py:10-51. Channels-last ``[S0, S1, S2, C]``.
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


def build_pos_enc(kind: str, channels: int,
                  dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    if kind == "sine":
        return PositionEmbeddingSine3D(channels, dtype)
    if kind == "learned":
        raise NotImplementedError(
            "the learned position encoding is not ported yet: ROADMAP "
            "Queue 1, item 7 (config keys no shipped config sets)")
    raise ValueError(f"unknown positional encoding: {kind}")
