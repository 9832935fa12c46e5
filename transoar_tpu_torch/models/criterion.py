"""Detection and segmentation-proxy losses of the Focused Decoder (port of
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
  batch-global count (``batch_normalizer`` summed over the dp ranks), so
  the ranks' losses sum to the global batch's.
- ``loss_segmentation``: cross-entropy + nnU-Net SoftDice (batch dice,
  softmax, background excluded, smooth 1e-5) of the seg-proxy head against
  the label batch (foreground / background under ``fg_bg``). Under dp
  (``group``, the dp process group) the SoftDice's sums are all-reduced
  with a differentiable all-reduce and both terms are divided by dp: each
  rank's share of the global batch's loss, whose sum over the ranks is it.
- ``build_criterion``: this Criterion for the focused neck, the DETR set
  criterion (``models/detr.SetCriterion``) for ``detr`` / ``def_detr``,
  ``models/retina.RetinaCriterion`` for a ``retina`` section.

The loss keys follow the reference, so ``total_loss`` weighs each by
``loss_coefs[key.split('_')[0]]``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from transoar_tpu_torch.models.detr import SetCriterion
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


def soft_dice_loss(logits, seg_onehot, smooth=1e-5, group=None):
    """nnU-Net SoftDice over batch and space, softmax, background excluded;
    logits / seg_onehot [B, S0, S1, S2, K]. With ``group`` the sums run
    over the group's ranks' batches too."""
    probs = logits.float().softmax(-1)
    dims = (0, 1, 2, 3)
    sums = torch.stack([(probs * seg_onehot).sum(dims),
                        (probs * (1.0 - seg_onehot)).sum(dims),
                        ((1.0 - probs) * seg_onehot).sum(dims)])
    if group is not None:
        from torch.distributed.nn.functional import all_reduce

        sums = all_reduce(sums, group=group)
    tp, fp, fn = sums
    dc = (2 * tp + smooth) / (2 * tp + fp + fn + smooth)
    return 1.0 - dc[1:].mean()


def loss_segmentation(pred_seg, seg_targets, fg_bg=True, group=None):
    """(CE, SoftDice) of pred_seg [B, S0, S1, S2, K] against the int labels
    seg_targets [B, S0, S1, S2]; with ``group`` (dp) this rank's share of
    the global batch's terms."""
    K = pred_seg.shape[-1]
    tgt = (seg_targets > 0).long() if fg_bg else seg_targets.long()
    onehot = F.one_hot(tgt, K).float()
    logp = pred_seg.float().log_softmax(-1)
    ce = -(onehot * logp).sum(-1).mean()
    dice = soft_dice_loss(pred_seg, onehot, group=group)
    if group is None:
        return ce, dice
    dp = torch.distributed.get_world_size(group)
    return ce / dp, dice / dp


class Criterion:
    """Matcher + losses (reference TransoarCriterion); holds only static
    config."""

    def __init__(self, config):
        self.num_organs = config["neck"]["num_organs"]
        m = config["matching"]
        self.cost_class = float(m["cost_class"])
        self.cost_bbox = float(m["cost_bbox"])
        self.cost_giou = float(m["cost_giou"])
        self.anchor_matching = bool(m["anchor_matching"])
        self.aux_loss = bool(config["neck"].get("aux_loss"))
        self.aux_on_final = bool(config["neck"].get("aux_loss_on_final"))
        self.seg_proxy = bool(config["backbone"].get("use_seg_proxy_loss"))
        self.fg_bg = bool(config["backbone"].get("fg_bg", True))

    def _match(self, logits, boxes, anchors, tgt_boxes, tgt_present):
        return match(logits.detach(), boxes.detach(), anchors, tgt_boxes,
                     tgt_present, self.num_organs,
                     cost_class=self.cost_class, cost_bbox=self.cost_bbox,
                     cost_giou=self.cost_giou,
                     anchor_matching=self.anchor_matching)

    def batch_normalizer(self, targets, anchors=None):
        """The batch's present-organ count (f32): summed over the dp ranks,
        the ``present_total`` of the global batch."""
        return targets["present"].sum().float()

    def __call__(self, outputs, targets, anchors, present_total=None,
                 group=None) -> Dict[str, Any]:
        """outputs: the model's dict; targets: {'boxes', 'present'[,
        'seg']}; ``group``: the dp group of the seg proxy's terms."""
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
        losses = {
            "bbox": l_bbox,
            "giou": l_giou,
            "cls": loss_class(outputs["pred_logits"], soft, self.num_organs,
                              count=cls_count),
        }
        if self.seg_proxy:
            losses["segce"], losses["segdice"] = loss_segmentation(
                outputs["pred_seg"], targets["seg"], self.fg_bg, group)
        else:
            zero = torch.zeros((), device=tgt_boxes.device)
            losses["segce"] = losses["segdice"] = zero

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
    """The focused neck's Criterion, the DETR necks' SetCriterion, and
    RetinaNet's RetinaCriterion for a config with a ``retina`` section."""
    if "retina" in config:
        from transoar_tpu_torch.models.retina import RetinaCriterion

        return RetinaCriterion(config)
    if config["neck"].get("name", "foc_attn") == "foc_attn":
        return Criterion(config)
    return SetCriterion(config)


def total_loss(losses, loss_coefs):
    """Weighted sum, coefficient looked up by key prefix."""
    return sum(v * loss_coefs[k.split("_")[0]] for k, v in losses.items())
