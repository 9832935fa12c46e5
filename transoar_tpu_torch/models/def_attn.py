"""Deformable-attention modules: the MSDeformAttn head and the FPN refine
block (port of ``transoar_tpu/models/def_attn.py``).

- ``MSDeformAttn``: ``value_proj`` / ``output_proj`` compute in ``dtype``;
  ``sampling_offsets`` and ``attention_weights`` are f32 layers on the f32
  query with zero kernels, the offsets' bias the directional grid of
  ``directional_offset_bias`` (6 or 26 heads); offsets are normalized by
  each level's shape in coordinate order (last axis first) and added to the
  reference points; the weights are a softmax over levels x points, rounded
  to the value's dtype, as the JAX module passes them on.
- ``DecoderDefAttnBlock``: the levels' tokens concatenated, sine position
  encoding plus an N(0, 1) level embedding, per-voxel reference points, and
  ``num_layers`` layers of deformable self-attention + FFN (post-norm).

Names follow the reference ``state_dict`` that
``transoar_tpu.utils.torch_import._map_refine`` reads: ``level_embed``,
``refine_def_attn.layers.{i}.self_attn.{value_proj, sampling_offsets,
attention_weights, output_proj}``, ``norm1``, ``linear1``, ``linear2``,
``norm2``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from transoar_tpu_torch.models.layers import (LayerNorm, Linear, dropout,
                                              feed_forward)
from transoar_tpu_torch.models.position_encoding import build_pos_enc
from transoar_tpu_torch.ops.deformable_attention import ms_deform_attn


def directional_offset_bias(n_heads, n_levels, n_points):
    """Init bias of the sampling-offset head: each head looks along one of
    the 6 (or 26) axis / diagonal directions, point i stepping i + 1 voxels
    (reference ms_deform_attn.py:63-82)."""
    dirs = np.array([[a, b, c] for a in (-1, 0, 1) for b in (-1, 0, 1)
                     for c in (-1, 0, 1)], np.float32)
    l1 = np.abs(dirs).sum(-1)
    if n_heads == 26:
        dirs = dirs[l1 > 0]
    elif n_heads == 6:
        dirs = dirs[(l1 > 0) & (l1 < 2)]
    else:
        raise ValueError("n_heads must be 6 or 26 for directional init, got "
                         f"{n_heads}")
    grid = np.tile(dirs[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class _SamplingOffsets(Linear):
    """Zero kernel, directional bias."""

    def __init__(self, d_model, n_heads, n_levels, n_points):
        super().__init__(d_model, n_heads * n_levels * n_points * 3,
                         dtype=torch.float32, init="zeros")
        self._bias_init = directional_offset_bias(n_heads, n_levels, n_points)

    def reset_parameters(self, generator=None):
        super().reset_parameters(generator)
        with torch.no_grad():
            self.bias.copy_(torch.from_numpy(self._bias_init))


class MSDeformAttn(nn.Module):

    def __init__(self, d_model: int, n_levels: int, n_heads: int,
                 n_points: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if d_model % n_heads:
            raise ValueError("d_model must divide n_heads")
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, \
            n_points
        self.value_proj = Linear(d_model, d_model, dtype=dtype,
                                 init="xavier")
        self.sampling_offsets = _SamplingOffsets(d_model, n_heads, n_levels,
                                                 n_points)
        self.attention_weights = Linear(d_model, n_heads * n_levels
                                        * n_points, dtype=torch.float32,
                                        init="zeros")
        self.output_proj = Linear(d_model, d_model, dtype=dtype,
                                  init="xavier")

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                input_flatten: torch.Tensor, spatial_shapes) -> torch.Tensor:
        """query [B, Q, C]; reference_points [B, Q, L, 3] (normalized,
        coordinate 0 = last axis); input_flatten [B, S, C]; spatial_shapes
        static [(s0, s1, s2)] * L -> [B, Q, C]."""
        B, Q, C = query.shape
        M, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(input_flatten).unflatten(-1, (M, C // M))
        q = query.float()
        offsets = self.sampling_offsets(q).view(B, Q, M, L, P, 3)
        weights = self.attention_weights(q).view(B, Q, M, L * P)
        weights = weights.softmax(-1).view(B, Q, M, L, P)
        normalizer = torch.tensor([[s2, s1, s0] for s0, s1, s2 in
                                   spatial_shapes], dtype=torch.float32,
                                  device=query.device)
        locations = (reference_points[:, :, None, :, None, :]
                     + offsets / normalizer[:, None, :])
        out = ms_deform_attn(value, spatial_shapes, locations,
                             weights.to(value.dtype))
        return self.output_proj(out)


def reference_points(spatial_shapes) -> np.ndarray:
    """Per-voxel normalized centers, coordinate 0 = last axis, concatenated
    over levels and repeated per level -> [S, L, 3] (reference
    decoder_blocks.py:107-131; the valid ratios are all ones)."""
    pts = []
    for s0, s1, s2 in spatial_shapes:
        g0, g1, g2 = np.meshgrid((np.arange(s0) + 0.5) / s0,
                                 (np.arange(s1) + 0.5) / s1,
                                 (np.arange(s2) + 0.5) / s2, indexing="ij")
        pts.append(np.stack([g2, g1, g0], -1).reshape(-1, 3))
    ref = np.concatenate(pts, 0).astype(np.float32)
    return np.tile(ref[:, None, :], (1, len(spatial_shapes), 1))


class DefAttnLayer(nn.Module):
    """Deformable self-attention + FFN, post-norm (``layers.{i}``)."""

    def __init__(self, d_model: int, dim_feedforward: int, p: float,
                 n_levels: int, n_heads: int, n_points: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.p = p
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                      dtype)
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.linear1 = Linear(d_model, dim_feedforward, dtype=dtype,
                              init="xavier")
        self.linear2 = Linear(dim_feedforward, d_model, dtype=dtype,
                              init="xavier")
        self.norm2 = LayerNorm(d_model, dtype=dtype)

    def forward(self, src, pos, ref, spatial_shapes, generator=None):
        p = self.p if self.training else 0.0
        attn = self.self_attn(src + pos, ref, src, spatial_shapes)
        src = self.norm1(src + dropout(attn, p, generator))
        return feed_forward(src, self.linear1, self.linear2, self.norm2, p,
                            generator)


class DecoderDefAttnBlock(nn.Module):
    """Refine FPN levels with deformable self-attention over their
    concatenated tokens (reference decoder_blocks.py:12-97)."""

    def __init__(self, hidden_dim: int, nheads: int, num_layers: int,
                 dim_feedforward: int, dropout: float, n_points: int,
                 n_levels: int, pos_encoding: str = "sine",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.level_embed = nn.Parameter(torch.empty(n_levels, hidden_dim))
        self._pos_enc = build_pos_enc(pos_encoding, hidden_dim, dtype)
        self.refine_def_attn = nn.ModuleDict({"layers": nn.ModuleList(
            DefAttnLayer(hidden_dim, dim_feedforward, dropout, n_levels,
                         nheads, n_points, dtype)
            for _ in range(num_layers))})
        self._refs: dict = {}

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.level_embed.normal_(0.0, 1.0, generator=generator)

    def _reference_points(self, spatial_shapes, device):
        key = (spatial_shapes, device)
        if key not in self._refs:
            with torch.inference_mode(False):  # as the sine tables
                self._refs[key] = torch.as_tensor(
                    reference_points(spatial_shapes), device=device)[None]
        return self._refs[key]

    def forward(self, fmaps: Sequence[torch.Tensor],
                generator: torch.Generator | None = None):
        """fmaps: list of [B, s0, s1, s2, C] -> the refined list."""
        B, C = fmaps[0].shape[0], fmaps[0].shape[-1]
        shapes = tuple(tuple(f.shape[1:4]) for f in fmaps)
        src = torch.cat([f.to(self.dtype).reshape(B, -1, C) for f in fmaps],
                        1)
        pos = torch.cat([
            (self._pos_enc(f) + self.level_embed[lvl].to(self.dtype))
            .reshape(B, -1, C) for lvl, f in enumerate(fmaps)], 1)
        ref = self._reference_points(shapes, src.device)
        for layer in self.refine_def_attn["layers"]:
            src = layer(src, pos, ref, shapes, generator)
        return [t.reshape(B, *s, C) for t, s in
                zip(src.split([int(np.prod(s)) for s in shapes], 1), shapes)]
