"""Focused Decoder neck: DETR-style decoder whose cross-attention reads only
each organ's static attention area.

Port of ``transoar_tpu/models/focused_decoder.py``. The numpy helpers that
build the per-organ attention bias and the RoI gather indices are copied
here (the JAX module imports jax); the parity tests pin them to the
originals.

- ``FocusedAttn`` keeps the reference quirk: queries are projected with the
  *key* projection (shared-QK attention), and the 1/sqrt(head_dim) scale is
  applied after the projection. Its default RoI path gathers each organ's
  tokens and runs dense attention over the crop, with f32 logits, the
  ``MASKED_BIAS`` on padded slots and an f32 softmax; the dense path adds the
  per-organ bias to full [B, H, Q, S] logits. Both give the same result.
- ``FocusedDecoderLayer``: self-attention -> focused cross-attention -> FFN,
  each with a residual and post-LayerNorm; names follow the reference
  (``self_attn``, ``norm2``, ``cross_attn``, ``norm1``, ``linear1``,
  ``linear2``, ``norm3``).
- ``FocusedDecoder`` returns the stacked outputs of every layer
  ``[L, B, Q, C]`` for the auxiliary heads.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from transoar_tpu_torch.models.layers import (LayerNorm, Linear,
                                              MultiHeadSelfAttention,
                                              feed_forward)

MASKED_BIAS = -1e9  # additive bias for voxels outside the organ's attn area


def level_spatial_shape(patch_size, level):
    """P-level spatial shape = patch_size // 2**level (reference tables,
    focused_decoder.py:99-117)."""
    return tuple(int(s) // (2 ** level) for s in patch_size)


def roi_token_indices(attn_bias, pad_multiple=128):
    """Static per-organ token gather indices from the attention bias.

    Returns (idx [organs, T] int32, valid [organs, T] bool) with T = max
    organ token count rounded up to ``pad_multiple``; padding slots point at
    token 0 and are masked.
    """
    organs = attn_bias.shape[0]
    token_lists = [np.nonzero(attn_bias[o] == 0)[0] for o in range(organs)]
    t_max = max((len(t) for t in token_lists), default=1)
    t_max = max(int(-(-t_max // pad_multiple)) * pad_multiple, pad_multiple)

    idx = np.zeros((organs, t_max), np.int32)
    valid = np.zeros((organs, t_max), bool)
    for o, tokens in enumerate(token_lists):
        idx[o, :len(tokens)] = tokens
        valid[o, :len(tokens)] = True
    return idx, valid


def generate_attn_bias(bbox_props, input_shape, restrict=True):
    """Per-organ additive attention bias over the flattened token axis
    (reference ``generate_attn_masks``, focused_decoder.py:138-159).

    Returns float32 ``[num_organs, S0*S1*S2]`` with 0 inside the organ's
    ``attn_area`` (scaled to the grid, floored/ceiled) and ``MASKED_BIAS``
    outside (all-zero if ``restrict`` is False).
    """
    shape = np.asarray(input_shape, np.float64)
    cls_ids = sorted(bbox_props.keys(), key=lambda k: int(k))
    num_organs = len(cls_ids)

    bias = np.zeros((num_organs, *input_shape), np.float32)
    if restrict:
        bias[:] = MASKED_BIAS
        for i, cls in enumerate(cls_ids):
            area = np.asarray(bbox_props[cls]["attn_area"], np.float64)
            vox = area * np.concatenate([shape, shape])
            vox = np.clip(vox, 0, np.concatenate([shape, shape]))
            lo = np.floor(vox[:3]).astype(int)
            hi = np.ceil(vox[3:]).astype(int)
            bias[i, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 0.0
    return bias.reshape(num_organs, -1)


class FocusedAttn(nn.Module):
    """Multi-head cross-attention with a static per-organ additive bias
    (reference FocusedAttn, focused_decoder.py:192-262)."""

    def __init__(self, d_model: int, num_heads: int, num_organs: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.num_organs = num_organs
        self.dtype = dtype
        self.k_proj = Linear(d_model, d_model, bias=False, dtype=dtype,
                             init="xavier")
        self.v_proj = Linear(d_model, d_model, bias=False, dtype=dtype,
                             init="xavier")
        self.proj = Linear(d_model, d_model, dtype=dtype, init="xavier")

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: torch.Tensor, roi=None) -> torch.Tensor:
        """q [B, Q, C]; k, v [B, S, C]; bias [organs, S] f32;
        roi: optional (idx [organs, T] long, valid [organs, T] bool)."""
        B, Q, C = q.shape
        H, hd = self.num_heads, C // self.num_heads
        O = self.num_organs
        qpo = Q // O

        kh = self.k_proj(k).unflatten(-1, (H, hd))
        vh = self.v_proj(v).unflatten(-1, (H, hd))
        qh = self.k_proj(q).unflatten(-1, (H, hd)) * hd ** -0.5

        if roi is not None:
            idx, valid = roi
            T = idx.shape[1]
            pad_bias = torch.where(valid, 0.0, MASKED_BIAS)
            flat = idx.reshape(-1)
            k_r = kh[:, flat].view(B, O, T, H, hd)
            v_r = vh[:, flat].view(B, O, T, H, hd)
            q_r = qh.view(B, O, qpo, H, hd)
            logits = torch.einsum("boqhd,bothd->bhoqt", q_r, k_r)
            logits = logits.float() + pad_bias[None, None, :, None, :]
            attn = logits.softmax(-1).to(self.dtype)
            out = torch.einsum("bhoqt,bothd->boqhd", attn, v_r)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
            logits = logits.view(B, H, O, qpo, -1).float() \
                + bias[None, None, :, None, :]
            attn = logits.softmax(-1).to(self.dtype).view(B, H, Q, -1)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, vh)
        return self.proj(out.reshape(B, Q, C))


class FocusedDecoderLayer(nn.Module):
    """Self-attn -> masked cross-attn -> FFN with post-norm residuals
    (reference FocusedDecoderLayer.forward, focused_decoder.py:171-189)."""

    def __init__(self, d_model: int, num_heads: int, num_organs: int,
                 dim_feedforward: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.self_attn = MultiHeadSelfAttention(d_model, num_heads, dtype)
        self.norm2 = LayerNorm(d_model, dtype=dtype)
        self.cross_attn = FocusedAttn(d_model, num_heads, num_organs, dtype)
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.linear1 = Linear(d_model, dim_feedforward, dtype=dtype,
                              init="xavier")
        self.linear2 = Linear(dim_feedforward, d_model, dtype=dtype,
                              init="xavier")
        self.norm3 = LayerNorm(d_model, dtype=dtype)

    def forward(self, tgt, query_pos, src, src_pos, bias, roi=None):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt))
        ca = self.cross_attn(tgt + query_pos, src + src_pos, src, bias, roi)
        tgt = self.norm1(tgt + ca)
        return feed_forward(tgt, self.linear1, self.linear2, self.norm3)


class FocusedDecoder(nn.Module):
    """Stack of FocusedDecoderLayers (``decoder.layers.{i}``) returning all
    intermediate outputs (reference focused_decoder.py:12-80).

    ``attn_bias`` [organs, S] and the optional ``roi`` (idx, valid) are
    numpy constants from ``build_transoarnet``; they become non-persistent
    buffers, so they move with the module and stay out of the state_dict.
    """

    def __init__(self, config: Dict[str, Any], attn_bias: np.ndarray,
                 roi=None, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if not config.get("share_qk_proj", True):
            raise NotImplementedError(
                "separate q_proj (share_qk_proj: false) is not ported: the "
                "reference and the flagship use shared-QK attention")
        C = config["hidden_dim"]
        self.dtype = dtype
        self.decoder = nn.ModuleDict({"layers": nn.ModuleList(
            FocusedDecoderLayer(C, config["nheads"], config["num_organs"],
                                config["dim_feedforward"], dtype)
            for _ in range(config["dec_layers"]))})
        self.register_buffer("attn_bias", torch.as_tensor(attn_bias),
                             persistent=False)
        self.use_roi = roi is not None and config.get("roi_attention", True)
        if self.use_roi:
            idx, valid = roi
            self.register_buffer("roi_idx", torch.as_tensor(
                np.asarray(idx, np.int64)), persistent=False)
            self.register_buffer("roi_valid", torch.as_tensor(
                np.asarray(valid, bool)), persistent=False)

    def forward(self, src: torch.Tensor, query_embed: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
        """src/pos [B, S0, S1, S2, C]; query_embed [Q, 2C]
        -> hs [L, B, Q, C]."""
        B, C = src.shape[0], src.shape[-1]
        src = src.reshape(B, -1, C)
        pos = pos.reshape(B, -1, C)
        query_pos, tgt = query_embed.chunk(2, dim=-1)
        query_pos = query_pos.to(self.dtype).expand(B, *query_pos.shape)
        tgt = tgt.to(self.dtype).expand(B, *tgt.shape)
        roi = (self.roi_idx, self.roi_valid) if self.use_roi else None

        intermediate = []
        for layer in self.decoder["layers"]:
            tgt = layer(tgt, query_pos, src, pos, self.attn_bias, roi)
            intermediate.append(tgt)
        return torch.stack(intermediate)
