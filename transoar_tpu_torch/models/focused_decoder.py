"""Focused Decoder neck: DETR-style decoder whose cross-attention reads only
each organ's static attention area.

Port of ``transoar_tpu/models/focused_decoder.py``. The numpy helpers that
build the per-organ attention bias and the RoI gather indices are copied
here (the JAX module imports jax); the parity tests pin them to the
originals.

- ``FocusedAttn`` keeps the reference quirk: queries are projected with the
  *key* projection (shared-QK attention; ``neck.share_qk_proj: false``
  gives them their own ``q_proj``), and the 1/sqrt(head_dim) scale is
  applied after the projection. Its default RoI path gathers each organ's
  tokens and runs dense attention over the crop, with f32 logits, the
  ``MASKED_BIAS`` on padded slots and an f32 softmax; the dense path adds the
  per-organ bias to full [B, H, Q, S] logits. Both give the same result.
  The RoI gather's backward adds each token's gradient up over the
  gather's inverse index (``roi_inverse_index``, built once with the model;
  ``ops/kernels/roi_gather.py``, a CUDA kernel on the card).
- ``FocusedDecoderLayer``: self-attention -> focused cross-attention -> FFN,
  each with a residual and post-LayerNorm; names follow the reference
  (``self_attn``, ``norm2``, ``cross_attn``, ``norm1``, ``linear1``,
  ``linear2``, ``norm3``).
- ``FocusedDecoder`` returns the stacked outputs of every layer
  ``[L, B, Q, C]`` for the auxiliary heads. With ``neck.remat`` (the JAX
  default: on for the dense path, whose f32 logits over every token would
  be kept for the backward, off with RoI attention) each layer runs under
  ``torch.utils.checkpoint`` when grad is enabled, the recompute replaying
  the forward's dropout masks (``layers.checkpoint_layer``).
- Dropout, in ``train()`` mode only, with masks from the generator passed
  to ``forward``: ``neck.dropout`` on the self-attention probabilities,
  after self- and cross-attention and twice in the FFN; the FocusedAttn
  output at a fixed 0.1 whatever ``neck.dropout`` says, as the JAX layer
  builds it.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from transoar_tpu_torch.models.layers import (LayerNorm, Linear,
                                              MultiHeadSelfAttention,
                                              checkpoint_layer, dropout,
                                              feed_forward)
from transoar_tpu_torch.ops.kernels.roi_gather import roi_gather

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


def roi_inverse_index(idx: torch.Tensor, valid: torch.Tensor,
                      num_tokens: int):
    """The inverse of the RoI gather index, in CSR form, with torch ops on
    ``idx``'s device and no sync with the host.

    idx [organs, T], valid [organs, T] -> (offsets [num_tokens + 1] int32,
    slots [organs * T] int32): the flat slots ``o * T + t`` that read token
    s are ``slots[offsets[s]:offsets[s + 1]]``, in ascending order. Only
    live slots are listed, in the first ``offsets[-1]`` entries; the rest
    are never read. A slot is live if it is valid: a pad slot's softmax
    weight is exactly 0 in f32, and so is its gradient. Only an organ with
    no valid slot at all has every slot live, since its softmax is then
    spread over its pads.
    """
    live = valid | ~valid.any(1, keepdim=True)
    key = torch.where(live.reshape(-1), idx.reshape(-1).long(), num_tokens)
    ordered, slots = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        ordered, torch.arange(num_tokens + 1, device=key.device))
    return offsets.int(), slots.int()


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
    (reference FocusedAttn, focused_decoder.py:192-262). Under tensor
    parallelism q, k, v are column-parallel (the rank's heads) and ``proj``
    row-parallel."""

    PROJ_DROP = 0.1  # fixed, whatever neck.dropout says, as the JAX layer

    def __init__(self, d_model: int, num_heads: int, num_organs: int,
                 dtype: torch.dtype = torch.bfloat16,
                 share_qk_proj: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.num_organs = num_organs
        self.dtype = dtype
        if not share_qk_proj:  # else q goes through k_proj, as the reference
            self.q_proj = Linear(d_model, d_model, bias=False, dtype=dtype,
                                 init="xavier")
        self.k_proj = Linear(d_model, d_model, bias=False, dtype=dtype,
                             init="xavier")
        self.v_proj = Linear(d_model, d_model, bias=False, dtype=dtype,
                             init="xavier")
        self.proj = Linear(d_model, d_model, dtype=dtype, init="xavier")

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: torch.Tensor, roi=None,
                generator: torch.Generator | None = None,
                return_weights: bool = False):
        """q [B, Q, C]; k, v [B, S, C]; bias [organs, S] f32;
        roi: optional (idx [organs, T] long, valid [organs, T] bool),
        optionally followed by its inverse (``roi_inverse_index``), which is
        otherwise built on the device from the pair.
        With ``return_weights`` also the attention weights over the full
        token axis [B, H, Q, S] (the RoI path scatters each organ's crop
        back onto it, f32)."""
        B, Q = q.shape[:2]
        hd = self.head_dim
        O = self.num_organs
        qpo = Q // O

        kh = self.k_proj(k)
        H = kh.shape[-1] // hd  # the local heads under tensor parallelism
        kh = kh.unflatten(-1, (H, hd))
        vh = self.v_proj(v).unflatten(-1, (H, hd))
        q_proj = getattr(self, "q_proj", self.k_proj)
        qh = q_proj(q).unflatten(-1, (H, hd)) * hd ** -0.5

        if roi is not None:
            idx, valid = roi[:2]
            inverse = roi[2:] or roi_inverse_index(idx, valid, kh.shape[1])
            T = idx.shape[1]
            pad_bias = torch.where(valid, 0.0, MASKED_BIAS)
            k_r, v_r = roi_gather(kh, vh, idx.reshape(-1), *inverse)
            k_r = k_r.view(B, O, T, H, hd)
            v_r = v_r.view(B, O, T, H, hd)
            q_r = qh.view(B, O, qpo, H, hd)
            logits = torch.einsum("boqhd,bothd->bhoqt", q_r, k_r)
            logits = logits.float() + pad_bias[None, None, :, None, :]
            attn = logits.softmax(-1).to(self.dtype)
            out = torch.einsum("bhoqt,bothd->boqhd", attn, v_r)
            weights = None
            if return_weights:
                weights = attn.new_zeros((B, H, O, qpo, kh.shape[1]),
                                         dtype=torch.float32)
                organ, slot = valid.nonzero(as_tuple=True)
                weights[:, :, organ, :, idx[organ, slot]] = \
                    attn[:, :, organ, :, slot].float()
                weights = weights.view(B, H, Q, -1)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
            logits = logits.view(B, H, O, qpo, -1).float() \
                + bias[None, None, :, None, :]
            attn = logits.softmax(-1).to(self.dtype).view(B, H, Q, -1)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, vh)
            weights = attn
        out = dropout(self.proj(out.reshape(B, Q, H * hd)),
                      self.PROJ_DROP if self.training else 0.0, generator)
        return (out, weights) if return_weights else out


class FocusedDecoderLayer(nn.Module):
    """Self-attn -> masked cross-attn -> FFN with post-norm residuals
    (reference FocusedDecoderLayer.forward, focused_decoder.py:171-189)."""

    def __init__(self, d_model: int, num_heads: int, num_organs: int,
                 dim_feedforward: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16,
                 share_qk_proj: bool = True):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadSelfAttention(d_model, num_heads, dropout,
                                                dtype)
        self.norm2 = LayerNorm(d_model, dtype=dtype)
        self.cross_attn = FocusedAttn(d_model, num_heads, num_organs, dtype,
                                      share_qk_proj)
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.linear1 = Linear(d_model, dim_feedforward, dtype=dtype,
                              init="xavier")
        self.linear2 = Linear(dim_feedforward, d_model, dtype=dtype,
                              init="xavier")
        self.norm3 = LayerNorm(d_model, dtype=dtype)

    def forward(self, tgt, query_pos, src, src_pos, bias, roi=None,
                generator=None, return_weights=False):
        """The layer's output, or (output, cross-attention weights
        [B, H, Q, S], self-attention weights [B, Q, Q]) with
        ``return_weights``."""
        p = self.dropout if self.training else 0.0
        q = tgt + query_pos
        sa = self.self_attn(q, q, tgt, generator, return_weights)
        if return_weights:
            sa, self_weights = sa
        tgt = self.norm2(tgt + dropout(sa, p, generator))
        ca = self.cross_attn(tgt + query_pos, src + src_pos, src, bias, roi,
                             generator, return_weights)
        if return_weights:
            ca, weights = ca
        tgt = self.norm1(tgt + dropout(ca, p, generator))
        tgt = feed_forward(tgt, self.linear1, self.linear2, self.norm3, p,
                           generator)
        return (tgt, weights, self_weights) if return_weights else tgt


class FocusedDecoder(nn.Module):
    """Stack of FocusedDecoderLayers (``decoder.layers.{i}``) returning all
    intermediate outputs (reference focused_decoder.py:12-80).

    ``attn_bias`` [organs, S] and the optional ``roi`` (idx, valid) are
    numpy constants from ``build_transoarnet``; they become non-persistent
    buffers, so they move with the module and stay out of the state_dict,
    as does the gather's inverse index (``roi_inv_offsets``,
    ``roi_inv_slots``: ``roi_inverse_index``, built here once).
    """

    def __init__(self, config: Dict[str, Any], attn_bias: np.ndarray,
                 roi=None, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        C = config["hidden_dim"]
        self.dtype = dtype
        self.decoder = nn.ModuleDict({"layers": nn.ModuleList(
            FocusedDecoderLayer(C, config["nheads"], config["num_organs"],
                                config["dim_feedforward"],
                                float(config.get("dropout", 0.0)), dtype,
                                bool(config.get("share_qk_proj", True)))
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
            offsets, slots = roi_inverse_index(
                self.roi_idx, self.roi_valid, self.attn_bias.shape[1])
            self.register_buffer("roi_inv_offsets", offsets,
                                 persistent=False)
            self.register_buffer("roi_inv_slots", slots[:int(offsets[-1])],
                                 persistent=False)
        self.remat = bool(config.get("remat", not self.use_roi))

    def forward(self, src: torch.Tensor, query_embed: torch.Tensor,
                pos: torch.Tensor,
                generator: torch.Generator | None = None,
                return_weights: bool = False):
        """src/pos [B, S0, S1, S2, C]; query_embed [Q, 2C]
        -> hs [L, B, Q, C], or (hs, {"cross": [B, H, Q, S], "self":
        [B, Q, Q]}) with the last layer's attention weights when
        ``return_weights`` (the reference's hooks on ``decoder.layers[-1]``,
        scripts/test.py:74-84)."""
        B, C = src.shape[0], src.shape[-1]
        src = src.reshape(B, -1, C)
        pos = pos.reshape(B, -1, C)
        query_pos, tgt = query_embed.chunk(2, dim=-1)
        query_pos = query_pos.to(self.dtype).expand(B, *query_pos.shape)
        tgt = tgt.to(self.dtype).expand(B, *tgt.shape)
        roi = (self.roi_idx, self.roi_valid, self.roi_inv_offsets,
               self.roi_inv_slots) if self.use_roi else None

        layers = self.decoder["layers"]
        remat = self.remat and torch.is_grad_enabled()
        intermediate = []
        for i, layer in enumerate(layers):
            last = return_weights and i == len(layers) - 1
            if remat and not last:
                tgt = checkpoint_layer(layer, generator, tgt, query_pos, src,
                                       pos, self.attn_bias, roi)
            else:
                tgt = layer(tgt, query_pos, src, pos, self.attn_bias, roi,
                            generator, last)
            if last:
                tgt, cross, self_weights = tgt
            intermediate.append(tgt)
        hs = torch.stack(intermediate)
        if return_weights:
            return hs, {"cross": cross, "self": self_weights}
        return hs
