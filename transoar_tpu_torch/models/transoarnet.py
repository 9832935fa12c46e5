"""TransoarNet: backbone + neck + heads (port of
``transoar_tpu/models/transoarnet.py``).

Necks: ``foc_attn`` (the Focused Decoder), ``detr`` (dense
cross-attention) and ``def_detr`` (deformable cross-attention over the
feature levels, ``models/detr.py``). Names follow the reference
``state_dict`` (``_backbone``, ``_neck``, ``_cls_head``,
``_reg_head.layers.{i}``, ``_query_embed.weight``, ``_seg_head``).

- Anchors, offset restrictions and the attention bias (focused neck only)
  are numpy constants computed once by ``build_transoarnet`` from the
  dataset statistics, held as non-persistent buffers.
- Boxes decode in f32 whatever the compute dtype:
  ``clip(tanh(raw) * restrictions + anchors, 0, 1)`` with anchors, the
  centers relative to the reference points' logit under Deformable DETR,
  else ``sigmoid(raw)``.
- Aux outputs are stacked ``[L-1, B, Q, .]``.
- With ``use_seg_proxy_loss`` a 1x1x1 ``_seg_head`` on P0 gives
  ``pred_seg`` (2 classes under ``fg_bg``, else organs + 1), f32.
- ``build_model`` builds RetinaNet (``models/retina.py``) for a config with
  a ``retina`` section.
- Under spatial parallelism (``parallel/sp.py``) the backbone runs on the
  rank's block of S0; the neck's levels and ``pred_seg`` (the seg head's K
  channels, not P0) are gathered whole (``AttnFPN.whole``), so the outputs
  are whole on every sp rank.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from transoar_tpu_torch.models.anchors import generate_anchors
from transoar_tpu_torch.models.attn_fpn import AttnFPN
from transoar_tpu_torch.models.detr import DeformableDETRDecoder, DETRDecoder
from transoar_tpu_torch.models.focused_decoder import (FocusedDecoder,
                                                       generate_attn_bias,
                                                       level_spatial_shape,
                                                       roi_token_indices)
from transoar_tpu_torch.models.layers import MLP, Linear
from transoar_tpu_torch.models.position_encoding import build_pos_enc
from transoar_tpu_torch.ops.conv3d import Conv3d
from transoar_tpu_torch.utils.spans import span


class TransoarNet(nn.Module):

    def __init__(self, config: Dict[str, Any], anchors=None,
                 restrictions=None, attn_bias=None, roi=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        neck = config["neck"]
        backbone = config["backbone"]
        C = neck["hidden_dim"]
        self.neck_name = neck.get("name", "foc_attn")
        self.aux_loss = bool(neck.get("aux_loss"))
        self._backbone = AttnFPN(backbone, dtype,
                                 config["augmentation"]["patch_size"])
        if self.neck_name == "def_detr":
            self.levels = list(neck.get("feature_levels")
                               or backbone["out_fmaps"])
            self._neck = DeformableDETRDecoder(neck, len(self.levels), dtype)
        else:
            self.input_level = neck["input_levels"]
            self._pos_enc = build_pos_enc(neck["pos_encoding"], C, dtype)
            self._neck = (DETRDecoder(neck, dtype) if self.neck_name == "detr"
                          else FocusedDecoder(neck, attn_bias, roi, dtype))
        self._query_embed = nn.Embedding(neck["num_queries"], 2 * C)
        # the focused neck scores one binary logit per query (class identity
        # is positional, reference transoarnet.py:35), the DETR necks
        # num_organs + 1 softmax classes; the heads start at zero for the
        # anchor-offset decode only (transoarnet.py:53-58)
        focused = self.neck_name == "foc_attn"
        zero = focused and anchors is not None
        self._cls_head = Linear(C, 1 if focused else neck["num_organs"] + 1,
                                dtype=dtype, init="zeros" if zero else "lecun")
        self._reg_head = MLP(C, C, 6, 3, dtype=dtype, zero_init_last=zero)
        if backbone.get("use_seg_proxy_loss"):
            self._seg_head = Conv3d(
                backbone["start_channels"],
                2 if backbone.get("fg_bg", True) else neck["num_organs"] + 1,
                1, dtype=dtype)
        for name, value in (("anchors", anchors),
                            ("restrictions", restrictions)):
            self.register_buffer(name, None if value is None else
                                 torch.as_tensor(value, dtype=torch.float32),
                                 persistent=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Initialise every parameter from ``generator``, as the JAX model's
        initialisers do (lecun-normal convs, xavier attention and FFN, unit
        norms, N(0, 1) query and level embeddings, zero heads under the
        anchor-offset decode)."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                if isinstance(module, nn.Embedding):
                    with torch.no_grad():
                        module.weight.normal_(0.0, 1.0, generator=generator)
                else:
                    module.reset_parameters(generator)

    def _decode(self, raw: torch.Tensor, ref: Optional[torch.Tensor]):
        """f32 box decode: the anchor offsets (focused neck), the centers
        relative to the reference points' logit (Deformable DETR), else a
        sigmoid."""
        if self.anchors is not None:
            return (torch.tanh(raw) * self.restrictions
                    + self.anchors).clamp(0.0, 1.0)
        if ref is None:
            return torch.sigmoid(raw)
        ref_logit = torch.log(ref.clamp_min(1e-6) / (1 - ref).clamp_min(1e-6))
        return torch.cat([torch.sigmoid(raw[..., :3] + ref_logit),
                          torch.sigmoid(raw[..., 3:])], dim=-1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                return_weights: bool = False) -> Dict[str, torch.Tensor]:
        """x [B, S0, S1, S2, C_in] -> pred_logits [B, Q, 1 or organs + 1],
        pred_boxes [B, Q, 6] and, with aux_loss, aux_logits / aux_boxes
        [L-1, B, Q, .]; with the seg proxy pred_seg [B, S0, S1, S2, K]; all
        f32. In ``train()`` mode the dropout and DropPath masks come from
        ``generator``. With ``return_weights`` also the last decoder layer's
        ``attn_weights`` ([B, H, Q, S] focused, [B, Q, S] DETR; Deformable
        DETR has none), the focused neck's ``self_attn_weights`` [B, Q, Q],
        and the neck's input ``backbone_fmap`` (f32), for the attention-map
        export of ``test.py --save_attn_map``."""
        feats = self._backbone(x, generator)
        query_embed = self._query_embed.weight
        weights, ref = None, None
        with span("model.neck"):
            if self.neck_name == "def_detr":
                hs, ref = self._neck([self._backbone.whole(feats[lv], lv)
                                      for lv in self.levels],
                                     query_embed, generator)
            else:
                src = self._backbone.whole(feats[self.input_level],
                                           self.input_level)
                hs = self._neck(src, query_embed, self._pos_enc(src),
                                generator, return_weights)  # [L, B, Q, C]
                if return_weights:
                    hs, weights = hs
        with span("model.heads"):
            logits = self._cls_head(hs).float()
            boxes = self._decode(self._reg_head(hs).float(), ref)
        out = {"pred_logits": logits[-1], "pred_boxes": boxes[-1]}
        if self.aux_loss:
            out["aux_logits"] = logits[:-1]
            out["aux_boxes"] = boxes[:-1]
        if hasattr(self, "_seg_head"):
            with span("model.seg_head"):
                out["pred_seg"] = self._backbone.whole(
                    self._seg_head(feats["P0"]).float(), "P0")
        if return_weights and self.neck_name != "def_detr":
            if isinstance(weights, dict):
                out["attn_weights"] = weights["cross"]
                out["self_attn_weights"] = weights["self"]
            else:
                out["attn_weights"] = weights
            out["backbone_fmap"] = src.float()
        return out


def build_transoarnet(config, dtype: Optional[torch.dtype] = None,
                      device=None,
                      generator: Optional[torch.Generator] = None):
    """Compute anchors, restrictions and the attention bias from
    ``config['bbox_properties']`` and build the model on ``device`` with
    parameters drawn from ``generator``.

    ``dtype`` defaults to the config's ``trainer.precision``.
    """
    neck = config["neck"]
    if dtype is None:
        precision = config.get("trainer", {}).get("precision", "bfloat16")
        dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32

    anchors = restrictions = attn_bias = roi = None
    if neck.get("name", "foc_attn") == "foc_attn":
        bbox_props = config["bbox_properties"]
        if neck["anchor_offset_pred"]:
            anchors, restrictions = generate_anchors(neck, bbox_props)
        level = int(neck["input_levels"][-1])
        input_shape = level_spatial_shape(
            config["augmentation"]["patch_size"], level)
        restrict = neck.get("restrict_attn", True)
        attn_bias = generate_attn_bias(bbox_props, input_shape,
                                       restrict=restrict)
        roi = roi_token_indices(attn_bias) \
            if restrict and neck.get("roi_attention", True) else None

    model = TransoarNet(config, anchors, restrictions, attn_bias, roi, dtype)
    model.reset_parameters(generator)
    return model if device is None else model.to(device)


def build_model(config, dtype: Optional[torch.dtype] = None, device=None,
                generator: Optional[torch.Generator] = None):
    """Top-level dispatch: a ``retina`` config section selects RetinaNet
    (``models/retina.py``), otherwise TransoarNet."""
    if "retina" in config:
        from transoar_tpu_torch.models.retina import build_retinanet

        return build_retinanet(config, dtype, device, generator)
    return build_transoarnet(config, dtype, device, generator)
