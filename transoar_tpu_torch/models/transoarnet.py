"""TransoarNet with the Focused Decoder neck: backbone + neck + heads.

Port of ``transoar_tpu/models/transoarnet.py`` for the ``foc_attn`` neck.
Names follow the reference ``state_dict`` (``_backbone``, ``_neck``,
``_cls_head``, ``_reg_head.layers.{i}``, ``_query_embed.weight``).

- Anchors, offset restrictions and the attention bias are numpy constants
  computed once by ``build_transoarnet`` from the dataset statistics, held
  as non-persistent buffers.
- Boxes decode in f32 whatever the compute dtype:
  ``clip(tanh(raw) * restrictions + anchors, 0, 1)``.
- Aux outputs are stacked ``[L-1, B, Q, .]``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from transoar_tpu_torch.models.anchors import generate_anchors
from transoar_tpu_torch.models.attn_fpn import AttnFPN
from transoar_tpu_torch.models.focused_decoder import (FocusedDecoder,
                                                       generate_attn_bias,
                                                       level_spatial_shape,
                                                       roi_token_indices)
from transoar_tpu_torch.models.layers import MLP, Linear
from transoar_tpu_torch.models.position_encoding import build_pos_enc


class TransoarNet(nn.Module):

    def __init__(self, config: Dict[str, Any], anchors: np.ndarray,
                 restrictions: np.ndarray, attn_bias: np.ndarray, roi=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        neck = config["neck"]
        C = neck["hidden_dim"]
        self.input_level = neck["input_levels"]
        self.aux_loss = bool(neck.get("aux_loss"))
        self._backbone = AttnFPN(config["backbone"], dtype,
                                 config["augmentation"]["patch_size"])
        self._pos_enc = build_pos_enc(neck["pos_encoding"], C, dtype)
        self._neck = FocusedDecoder(neck, attn_bias, roi, dtype)
        self._query_embed = nn.Embedding(neck["num_queries"], 2 * C)
        # binary logit per query: class identity is positional
        # (reference transoarnet.py:35); heads zero-initialised for the
        # anchor-offset decode (transoarnet.py:53-58)
        self._cls_head = Linear(C, 1, dtype=dtype, init="zeros")
        self._reg_head = MLP(C, C, 6, 3, dtype=dtype, zero_init_last=True)
        self.register_buffer("anchors", torch.as_tensor(
            anchors, dtype=torch.float32), persistent=False)
        self.register_buffer("restrictions", torch.as_tensor(
            restrictions, dtype=torch.float32), persistent=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Initialise every parameter from ``generator``, as the JAX model's
        initialisers do (lecun-normal convs, xavier attention and FFN, unit
        norms, N(0, 1) query embedding, zero heads)."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                if isinstance(module, nn.Embedding):
                    with torch.no_grad():
                        module.weight.normal_(0.0, 1.0, generator=generator)
                else:
                    module.reset_parameters(generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                return_weights: bool = False) -> Dict[str, torch.Tensor]:
        """x [B, S0, S1, S2, C_in] -> pred_logits [B, Q, 1],
        pred_boxes [B, Q, 6] and, with aux_loss, aux_logits [L-1, B, Q, 1],
        aux_boxes [L-1, B, Q, 6]; all f32. In ``train()`` mode the neck's
        dropout masks and the Swin stages' DropPath masks come from
        ``generator``. With ``return_weights`` also the last decoder layer's
        ``attn_weights`` [B, H, Q, S] and ``self_attn_weights`` [B, Q, Q] and
        the neck's input ``backbone_fmap`` (f32), for the attention-map
        export of ``test.py --save_attn_map``."""
        src = self._backbone(x, generator)[self.input_level]
        pos = self._pos_enc(src)
        hs = self._neck(src, self._query_embed.weight, pos, generator,
                        return_weights)  # [L, B, Q, C]
        if return_weights:
            hs, weights = hs
        logits = self._cls_head(hs).float()
        raw = self._reg_head(hs).float()
        boxes = (torch.tanh(raw) * self.restrictions
                 + self.anchors).clamp(0.0, 1.0)
        out = {"pred_logits": logits[-1], "pred_boxes": boxes[-1]}
        if self.aux_loss:
            out["aux_logits"] = logits[:-1]
            out["aux_boxes"] = boxes[:-1]
        if return_weights:
            out["attn_weights"] = weights["cross"]
            out["self_attn_weights"] = weights["self"]
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
    name = neck.get("name", "foc_attn")
    if name != "foc_attn":
        raise NotImplementedError(
            f"the {name} neck is not ported yet: ROADMAP Queue 1 "
            "(DETR and deformable families)")
    if not neck["anchor_offset_pred"]:
        raise NotImplementedError(
            "the sigmoid box decode (anchor_offset_pred: false) is not "
            "ported yet: ROADMAP Queue 1")
    if dtype is None:
        precision = config.get("trainer", {}).get("precision", "bfloat16")
        dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32

    bbox_props = config["bbox_properties"]
    anchors, restrictions = generate_anchors(neck, bbox_props)
    level = int(neck["input_levels"][-1])
    input_shape = level_spatial_shape(config["augmentation"]["patch_size"],
                                      level)
    restrict = neck.get("restrict_attn", True)
    attn_bias = generate_attn_bias(bbox_props, input_shape, restrict=restrict)
    roi = roi_token_indices(attn_bias) \
        if restrict and neck.get("roi_attention", True) else None

    model = TransoarNet(config, anchors, restrictions, attn_bias, roi, dtype)
    model.reset_parameters(generator)
    return model if device is None else model.to(device)


def build_model(config, dtype: Optional[torch.dtype] = None, device=None,
                generator: Optional[torch.Generator] = None):
    """Top-level dispatch: a ``retina`` config section selects RetinaNet,
    otherwise TransoarNet."""
    if "retina" in config:
        raise NotImplementedError(
            "RetinaNet is not ported yet: ROADMAP Queue 1, item 6 "
            "(RetinaNet / Retina U-Net)")
    return build_transoarnet(config, dtype, device, generator)
