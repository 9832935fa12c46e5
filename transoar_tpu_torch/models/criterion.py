"""Detection losses of the Focused Decoder (port of
``transoar_tpu/models/criterion.py``), f32 scalars on the device.

- ``loss_class``: BCE-with-logits against the matcher's soft labels,
  averaged over the present organs' queries.
- ``loss_bboxes``: L1 and 1 - GIoU of each present organ's matched query,
  normalized by the number of ground-truth boxes; the matched query comes
  from a one-hot contraction (static shapes).
- Auxiliary layers are re-matched; by default each is supervised on its own
  outputs, with ``aux_loss_on_final`` on the final outputs as the
  reference does.
- ``present_total`` replaces the two batch-coupling normalizers by a
  batch-global count, so per-sample calls sum to the batched loss.

The loss keys follow the reference, so ``total_loss`` weighs each by
``loss_coefs[key.split('_')[0]]``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from transoar_tpu_torch.models.matcher import match
from transoar_tpu_torch.utils.boxes import (box_cxcyczwhd_to_xyzxyz,
                                            generalized_box_iou_elementwise)


def loss_class(pred_logits, soft_labels, num_organs, count=None):
    """BCE on soft labels; mean over valid entries unless ``count`` is
    given."""
    B = pred_logits.shape[0]
    logits = pred_logits.reshape(B, num_organs, -1).float()
    valid = soft_labels != -1
    bce = F.binary_cross_entropy_with_logits(
        logits, soft_labels.clamp_min(0.0), reduction="none")
    total = torch.where(valid, bce, 0.0).sum()
    if count is None:
        count = valid.sum().clamp_min(1)
    return total / count


def loss_bboxes(pred_boxes, matches, tgt_boxes, tgt_present, num_organs,
                num_boxes=None):
    """Matched-query (L1, GIoU) losses."""
    B = pred_boxes.shape[0]
    boxes = pred_boxes.reshape(B, num_organs, -1, 6).float()
    matched = torch.einsum("boq,boqc->boc", matches, boxes)
    tgt = tgt_boxes.float()
    present = tgt_present.float()
    if num_boxes is None:
        num_boxes = present.sum().clamp_min(1.0)

    loss_l1 = ((matched - tgt).abs().sum(-1) * present).sum() / num_boxes
    giou = generalized_box_iou_elementwise(
        box_cxcyczwhd_to_xyzxyz(matched.clamp_min(0.0)),
        box_cxcyczwhd_to_xyzxyz(tgt))
    loss_giou = ((1.0 - giou) * present).sum() / num_boxes
    return loss_l1, loss_giou


class Criterion:
    """Matcher + losses (reference TransoarCriterion); holds only static
    config."""

    def __init__(self, config):
        if config["backbone"].get("use_seg_proxy_loss"):
            raise NotImplementedError(
                "the segmentation-proxy loss is not ported yet: ROADMAP "
                "Queue 1, item 1 (seg proxy)")
        self.num_organs = config["neck"]["num_organs"]
        m = config["matching"]
        self.cost_class = float(m["cost_class"])
        self.cost_bbox = float(m["cost_bbox"])
        self.cost_giou = float(m["cost_giou"])
        self.anchor_matching = bool(m["anchor_matching"])
        self.aux_loss = bool(config["neck"].get("aux_loss"))
        self.aux_on_final = bool(config["neck"].get("aux_loss_on_final"))

    def _match(self, logits, boxes, anchors, tgt_boxes, tgt_present):
        return match(logits.detach(), boxes.detach(), anchors, tgt_boxes,
                     tgt_present, self.num_organs,
                     cost_class=self.cost_class, cost_bbox=self.cost_bbox,
                     cost_giou=self.cost_giou,
                     anchor_matching=self.anchor_matching)

    def __call__(self, outputs, targets, anchors,
                 present_total=None) -> Dict[str, Any]:
        """outputs: the model's dict; targets: {'boxes', 'present'}."""
        tgt_boxes, tgt_present = targets["boxes"], targets["present"]

        num_boxes = cls_count = None
        if present_total is not None:
            qpo = outputs["pred_logits"].shape[1] // self.num_organs
            present_total = torch.as_tensor(present_total,
                                            device=tgt_boxes.device)
            cls_count = (present_total * qpo).clamp_min(1)
            num_boxes = present_total.float().clamp_min(1.0)

        matches, soft = self._match(
            outputs["pred_logits"], outputs["pred_boxes"], anchors,
            tgt_boxes, tgt_present)
        l_bbox, l_giou = loss_bboxes(
            outputs["pred_boxes"], matches, tgt_boxes, tgt_present,
            self.num_organs, num_boxes=num_boxes)
        zero = torch.zeros((), device=tgt_boxes.device)
        losses = {
            "bbox": l_bbox,
            "giou": l_giou,
            "cls": loss_class(outputs["pred_logits"], soft, self.num_organs,
                              count=cls_count),
            "segce": zero,
            "segdice": zero,
        }

        if self.aux_loss and "aux_logits" in outputs:
            for i in range(outputs["aux_logits"].shape[0]):
                a_logits = outputs["aux_logits"][i]
                a_boxes = outputs["aux_boxes"][i]
                m_i, s_i = self._match(a_logits, a_boxes, anchors,
                                       tgt_boxes, tgt_present)
                if self.aux_on_final:
                    l_logits, l_boxes = (outputs["pred_logits"],
                                         outputs["pred_boxes"])
                else:
                    l_logits, l_boxes = a_logits, a_boxes
                lb, lg = loss_bboxes(l_boxes, m_i, tgt_boxes, tgt_present,
                                     self.num_organs, num_boxes=num_boxes)
                losses[f"bbox_{i}"] = lb
                losses[f"giou_{i}"] = lg
                losses[f"cls_{i}"] = loss_class(l_logits, s_i,
                                                self.num_organs,
                                                count=cls_count)
        return losses


def build_criterion(config):
    """The focused branch's Criterion; RetinaNet and DETR raise."""
    if "retina" in config:
        raise NotImplementedError(
            "the RetinaNet criterion is not ported yet: ROADMAP Queue 1, "
            "item 5 (RetinaNet)")
    if config["neck"].get("name", "foc_attn") != "foc_attn":
        raise NotImplementedError(
            "the DETR set criterion is not ported yet: ROADMAP Queue 1, "
            "item 4 (deformable family)")
    return Criterion(config)


def total_loss(losses, loss_coefs):
    """Weighted sum, coefficient looked up by key prefix."""
    return sum(v * loss_coefs[k.split("_")[0]] for k, v in losses.items())
