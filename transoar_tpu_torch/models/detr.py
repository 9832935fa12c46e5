"""DETR and Deformable-DETR necks and the set criterion (port of
``transoar_tpu/models/detr.py``).

- ``DETRDecoder``: query self-attention, dense cross-attention over the
  flattened feature level (``layers.MultiHeadSelfAttention``), FFN;
  post-norm; every layer's output stacked for the aux losses; the last
  layer's head-averaged cross-attention weights under ``return_weights``.
  With the neck's ``remat`` (default true, as the JAX decoder's
  ``nn.remat``) each layer runs under ``torch.utils.checkpoint`` when grad
  is enabled; its recompute draws the same dropout masks from a copy of
  the generator's state.
- ``DeformableDETRDecoder``: learned reference points, sigmoid(Linear(3))
  of the f32 query position embedding, and ``MSDeformAttn``
  cross-attention over the feature levels; returns the layers' outputs and
  the reference points.
- ``SetCriterion``: the cost of every decoder layer at once, one exact
  assignment on the host (``models/hungarian.py``: the step's one host
  sync), then per layer softmax cross-entropy with a no-object class
  weighted ``eos_coef`` (absent slots write no target), and L1 + GIoU on
  the matched pairs, normalized by the present boxes. All f32. Under dp
  the two normalizers come from ``batch_normalizer`` summed over the
  ranks (``present_total``): the present boxes and the class weights'
  sum, both functions of the present count.

Parameter names (the reference's DETR branches are not in this checkout):
``_neck.layers.{i}.{self_attn, norm_sa, cross_attn, norm_ca, ffn}``, and
``_neck.ref_points`` for Deformable DETR.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from transoar_tpu_torch.models.def_attn import MSDeformAttn
from transoar_tpu_torch.models.hungarian import MatchClock, hungarian_match
from transoar_tpu_torch.models.layers import (FFN, LayerNorm, Linear,
                                              MultiHeadSelfAttention,
                                              checkpoint_layer, dropout)
from transoar_tpu_torch.utils.boxes import (box_cxcyczwhd_to_xyzxyz,
                                            generalized_box_iou_elementwise,
                                            generalized_box_iou_pairwise)


class DETRDecoderLayer(nn.Module):

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 p: float = 0.1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.p = p
        self.self_attn = MultiHeadSelfAttention(d_model, num_heads, p, dtype)
        self.norm_sa = LayerNorm(d_model, dtype=dtype)
        self.cross_attn = MultiHeadSelfAttention(d_model, num_heads, p, dtype)
        self.norm_ca = LayerNorm(d_model, dtype=dtype)
        self.ffn = FFN(d_model, dim_feedforward, p, dtype)

    def forward(self, tgt, query_pos, src, src_pos, generator=None,
                return_weights=False):
        """The layer's output, or (output, head-averaged cross-attention
        weights [B, Q, S]) with ``return_weights``."""
        p = self.p if self.training else 0.0
        q = tgt + query_pos
        sa = self.self_attn(q, q, tgt, generator)
        tgt = self.norm_sa(tgt + dropout(sa, p, generator))
        ca = self.cross_attn(tgt + query_pos, src + src_pos, src, generator,
                             return_weights)
        if return_weights:
            ca, weights = ca
        tgt = self.norm_ca(tgt + dropout(ca, p, generator))
        out = self.ffn(tgt, generator)
        return (out, weights) if return_weights else out


def _split_queries(query_embed, B, dtype):
    query_pos, tgt = query_embed.chunk(2, dim=-1)
    return (query_pos, query_pos.to(dtype).expand(B, *query_pos.shape),
            tgt.to(dtype).expand(B, *tgt.shape))


class DETRDecoder(nn.Module):
    """Dense-cross-attention decoder; the FocusedDecoder's interface."""

    def __init__(self, config: Dict[str, Any],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.remat = bool(config.get("remat", True))
        self.layers = nn.ModuleList(
            DETRDecoderLayer(config["hidden_dim"], config["nheads"],
                             config["dim_feedforward"],
                             float(config["dropout"]), dtype)
            for _ in range(config["dec_layers"]))

    def forward(self, src, query_embed, pos, generator=None,
                return_weights=False):
        """src / pos [B, S0, S1, S2, C]; query_embed [Q, 2C] -> hs
        [L, B, Q, C], or (hs, the last layer's weights [B, Q, S]) with
        ``return_weights``."""
        B, C = src.shape[0], src.shape[-1]
        src = src.reshape(B, -1, C)
        pos = pos.reshape(B, -1, C)
        _, query_pos, tgt = _split_queries(query_embed, B, self.dtype)
        remat = self.remat and torch.is_grad_enabled()
        intermediate, weights = [], None
        for i, layer in enumerate(self.layers):
            if return_weights and i == len(self.layers) - 1:
                tgt, weights = layer(tgt, query_pos, src, pos, generator,
                                     True)
            elif remat:
                tgt = checkpoint_layer(layer, generator, tgt, query_pos, src,
                                       pos)
            else:
                tgt = layer(tgt, query_pos, src, pos, generator)
            intermediate.append(tgt)
        hs = torch.stack(intermediate)
        return (hs, weights) if return_weights else hs


class DeformableDETRDecoderLayer(nn.Module):

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 p: float, n_levels: int, n_points: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.p = p
        self.n_levels = n_levels
        self.self_attn = MultiHeadSelfAttention(d_model, num_heads, p, dtype)
        self.norm_sa = LayerNorm(d_model, dtype=dtype)
        self.cross_attn = MSDeformAttn(d_model, n_levels, num_heads, n_points,
                                       dtype)
        self.norm_ca = LayerNorm(d_model, dtype=dtype)
        self.ffn = FFN(d_model, dim_feedforward, p, dtype)

    def forward(self, tgt, query_pos, ref_points, src, spatial_shapes,
                generator=None):
        """ref_points [B, Q, 3], shared by every level."""
        p = self.p if self.training else 0.0
        q = tgt + query_pos
        sa = self.self_attn(q, q, tgt, generator)
        tgt = self.norm_sa(tgt + dropout(sa, p, generator))
        B, Q = ref_points.shape[:2]
        ref = ref_points[:, :, None, :].expand(B, Q, self.n_levels, 3)
        ca = self.cross_attn(tgt + query_pos, ref, src, spatial_shapes)
        tgt = self.norm_ca(tgt + dropout(ca, p, generator))
        return self.ffn(tgt, generator)


class DeformableDETRDecoder(nn.Module):
    """Deformable-DETR decoder over the feature levels."""

    def __init__(self, config: Dict[str, Any], n_levels: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        C = config["hidden_dim"]
        self.ref_points = Linear(C, 3, dtype=torch.float32)
        self.layers = nn.ModuleList(
            DeformableDETRDecoderLayer(
                C, config["nheads"], config["dim_feedforward"],
                float(config["dropout"]), n_levels,
                config.get("n_points", 4), dtype)
            for _ in range(config["dec_layers"]))

    def forward(self, fmaps, query_embed, generator=None):
        """fmaps: list of [B, s0, s1, s2, C]; query_embed [Q, 2C] ->
        (hs [L, B, Q, C], reference points [B, Q, 3] f32)."""
        B, C = fmaps[0].shape[0], fmaps[0].shape[-1]
        shapes = tuple(tuple(f.shape[1:4]) for f in fmaps)
        src = torch.cat([f.to(self.dtype).reshape(B, -1, C) for f in fmaps],
                        1)
        pos32, query_pos, tgt = _split_queries(query_embed, B, self.dtype)
        ref = torch.sigmoid(self.ref_points(pos32)).expand(B, -1, 3)
        intermediate = []
        for layer in self.layers:
            tgt = layer(tgt, query_pos, ref, src, shapes, generator)
            intermediate.append(tgt)
        return torch.stack(intermediate), ref


def hungarian_cost(class_probs, pred_boxes, tgt_boxes, tgt_present,
                   cost_class=1.0, cost_bbox=5.0, cost_giou=2.0):
    """class_probs [..., B, Q, K+1], pred_boxes [..., B, Q, 6], tgt_boxes
    [B, G, 6], tgt_present [B, G] -> cost [..., B, G, Q], zero on absent
    slots; GT slot g is class g + 1."""
    G = tgt_boxes.shape[-2]
    c_class = -class_probs[..., 1:G + 1].transpose(-1, -2)
    c_bbox = (tgt_boxes[..., :, None, :]
              - pred_boxes[..., None, :, :]).abs().sum(-1)
    giou = generalized_box_iou_pairwise(
        box_cxcyczwhd_to_xyzxyz(tgt_boxes),
        box_cxcyczwhd_to_xyzxyz(pred_boxes.clamp_min(0.0)))
    cost = cost_class * c_class + cost_bbox * c_bbox - cost_giou * giou
    return torch.where(tgt_present[:, :, None], cost, 0.0)


class SetCriterion:
    """DETR set-prediction loss on an exact assignment."""

    def __init__(self, config):
        self.num_classes = config["neck"]["num_organs"]
        self.num_queries = int(config["neck"]["num_queries"])
        m = config["matching"]
        self.cost_class = float(m.get("cost_class", 1))
        self.cost_bbox = float(m.get("cost_bbox", 5))
        self.cost_giou = float(m.get("cost_giou", 2))
        self.eos_coef = float(m.get("eos_coef", 0.1))
        self.aux_loss = bool(config["neck"].get("aux_loss"))
        self.clock = MatchClock()

    def batch_normalizer(self, targets, anchors=None):
        """[present boxes, class weights' sum] of the batch, f32. Every
        present box is matched to one query, so the weights sum to
        present + eos_coef * (B * Q - present) whichever queries the match
        picks; both are sums over the rows."""
        present = targets["present"].sum().float()
        B = targets["present"].shape[0]
        return torch.stack([present, present + (B * self.num_queries
                                                - present) * self.eos_coef])

    def _losses(self, logits, boxes, assign, tgt_boxes, tgt_present,
                norm=None):
        """One layer: logits [B, Q, K+1], boxes [B, Q, 6], assign [B, G];
        ``norm``: ``batch_normalizer``'s pair, else this batch's."""
        B, Q, _ = logits.shape
        G = tgt_boxes.shape[1]
        # absent slots write to a dropped column Q, never to query 0
        cols = torch.where(tgt_present, assign, Q)
        classes = torch.arange(1, G + 1, device=logits.device).expand(B, G)
        target = torch.zeros(B, Q + 1, dtype=torch.long,
                             device=logits.device)
        target = target.scatter(1, cols, classes)[:, :Q]
        ce = F.cross_entropy(logits.transpose(1, 2), target,
                             reduction="none")
        weights = torch.where(target > 0, 1.0, self.eos_coef)
        weight_total = weights.sum() if norm is None else norm[1]
        loss_ce = (ce * weights).sum() / weight_total

        matched = boxes.gather(1, assign.clamp_min(0)[..., None].expand(
            B, G, 6))
        present = tgt_present.float()
        num_boxes = (present.sum() if norm is None else norm[0]).clamp_min(
            1.0)
        l1 = ((matched - tgt_boxes).abs().sum(-1) * present).sum() / num_boxes
        giou = generalized_box_iou_elementwise(
            box_cxcyczwhd_to_xyzxyz(matched.clamp_min(0.0)),
            box_cxcyczwhd_to_xyzxyz(tgt_boxes))
        loss_giou = ((1.0 - giou) * present).sum() / num_boxes
        return loss_ce, l1, loss_giou

    def __call__(self, outputs, targets, anchors=None, present_total=None,
                 group=None) -> Dict[str, Any]:
        """outputs: the model's dict; targets: {'boxes', 'present'};
        ``present_total``: ``batch_normalizer`` of the global batch."""
        tgt_boxes = targets["boxes"].float()
        tgt_present = targets["present"]
        logits = outputs["pred_logits"][None].float()
        boxes = outputs["pred_boxes"][None].float()
        if self.aux_loss and "aux_logits" in outputs:
            logits = torch.cat([logits, outputs["aux_logits"].float()])
            boxes = torch.cat([boxes, outputs["aux_boxes"].float()])
        with torch.no_grad():
            cost = hungarian_cost(logits.softmax(-1), boxes, tgt_boxes,
                                  tgt_present, self.cost_class,
                                  self.cost_bbox, self.cost_giou)
        assign = hungarian_match(cost, tgt_present, self.clock)

        losses = {}
        zero = torch.zeros((), device=tgt_boxes.device)
        for i in range(logits.shape[0]):
            ce, l1, giou = self._losses(logits[i], boxes[i], assign[i],
                                        tgt_boxes, tgt_present,
                                        present_total)
            suffix = "" if i == 0 else f"_{i - 1}"
            losses.update({f"cls{suffix}": ce, f"bbox{suffix}": l1,
                           f"giou{suffix}": giou})
            if i == 0:
                losses.update(segce=zero, segdice=zero)
        return losses
