"""Query-target matching of the Focused Decoder (port of
``transoar_tpu/models/matcher.py``).

Each organ owns ``qpo`` consecutive queries and has at most one ground-truth
box, so matching is a ``[B, organs, qpo]`` argmin of

    cost = cost_class * (-sigmoid(logit)) + cost_bbox * L1(box, gt)
         + cost_giou * (-GIoU(box, gt))

where, with ``anchor_matching``, the boxes are the static anchors. Soft
labels are the normalized GIoU-cost ramp ``((c - max) / (min - max))``
clipped at 0; an absent organ gets no match and soft label -1. Everything
stays on the device: no host sync.
"""

from __future__ import annotations

import torch

from transoar_tpu_torch.utils.boxes import (box_cxcyczwhd_to_xyzxyz,
                                            generalized_box_iou_pairwise)


@torch.no_grad()
def match(pred_logits, pred_boxes, anchors, tgt_boxes, tgt_present,
          num_organs, cost_class=1.0, cost_bbox=0.0, cost_giou=0.0,
          anchor_matching=True):
    """pred_logits [B, Q, 1], pred_boxes [B, Q, 6], anchors [Q, 6] (or None
    without ``anchor_matching``), tgt_boxes [B, organs, 6], tgt_present
    [B, organs] bool -> (matches [B, organs, qpo] one-hot f32,
    soft_labels [B, organs, qpo], -1 where the organ is absent)."""
    B, Q, _ = pred_logits.shape
    qpo = Q // num_organs

    logits = pred_logits.reshape(B, num_organs, qpo).float()
    if anchor_matching:
        boxes = anchors.reshape(1, num_organs, qpo, 6).float().expand(
            B, -1, -1, -1)
    else:
        boxes = pred_boxes.reshape(B, num_organs, qpo, 6).float()
    tgt = tgt_boxes.float()

    c_class = -torch.sigmoid(logits).clamp(0.0, 1.0)
    c_bbox = (boxes - tgt[:, :, None, :]).abs().sum(-1)
    q_corner = box_cxcyczwhd_to_xyzxyz(boxes.clamp_min(0.0))
    t_corner = box_cxcyczwhd_to_xyzxyz(tgt)[:, :, None, :]
    c_giou = -generalized_box_iou_pairwise(q_corner, t_corner)[..., 0]

    cost = cost_bbox * c_bbox + cost_class * c_class + cost_giou * c_giou
    matches = torch.zeros_like(cost).scatter_(
        -1, cost.argmin(-1, keepdim=True), 1.0)

    c_max = c_giou.amax(-1, keepdim=True)
    c_min = c_giou.amin(-1, keepdim=True)
    denom = c_min - c_max
    soft = torch.where(denom.abs() > 1e-12, (c_giou - c_max) / denom, 1.0)
    soft = soft.clamp_min(0.0)

    present = tgt_present[:, :, None]
    return (torch.where(present, matches, 0.0),
            torch.where(present, soft, -1.0))
