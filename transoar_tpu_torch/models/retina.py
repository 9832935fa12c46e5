"""RetinaNet / Retina U-Net (port of ``transoar_tpu/models/retina.py``):
dense anchors, shared conv towers, the focal criterion and the NMS decode.

- ``generate_level_anchors`` / ``build_anchors``: host numpy copies (pinned
  by ``tests/test_torch_copies.py``): per P-level, anchors at every voxel
  with ``scales x ratios`` sizes, normalized cxcyczwhd, voxel-major then
  size (anchor ``voxel * K + k``).
- ``encode_deltas`` / ``decode_deltas``: f32 tensor functions (the size
  clipped at 1e-6 in encode, the log-size deltas to [-6, 6] in decode).
- ``RetinaNet``: the AttnFPN backbone, then ONE ``_cls_tower`` and ONE
  ``_reg_tower`` applied to every level of ``retina.levels`` (their
  gradients sum over the levels): ``tower_depth`` 3x3x3 convs with ReLU and
  an ``out`` conv, whose bias starts at -log(99) for the classes. Outputs
  ``anchor_logits`` [B, A, C] and ``anchor_deltas`` [B, A, 6] in f32, the
  channels ``k * C + c`` of a voxel flattened to anchor ``voxel * K + k``;
  with ``use_seg_proxy_loss`` also ``pred_seg`` from a 1x1x1 ``_seg_head``
  on P0 (Retina U-Net). ``retina.tower_conv`` picks an XLA lowering in the
  JAX package and is ignored here. Under spatial parallelism
  (``parallel/sp.py``) the towers run on the gathered levels, replicated
  over sp, and ``pred_seg`` is gathered after the seg head.
- ``RetinaCriterion``: max-IoU assignment against the present GT boxes
  (positive >= ``pos_iou``, negative < ``neg_iou``, the rest ignored),
  sigmoid focal loss over the valid anchors, L1 on the encoded deltas and
  1 - GIoU on the decoded, clipped boxes of the positives, all over the
  batch's ``max(num_pos, 1)`` (under dp the global batch's, from
  ``batch_normalizer`` summed over the ranks); Retina U-Net adds the seg
  losses.
- ``retina_inference``: on the outputs' device, one ``topk`` of
  ``candidates`` anchors per class (sorted by score, ties in ``topk``'s
  order), only those decoded, every class of every volume suppressed in
  one ``nms_3d`` call; only the kept slots go to the host, as the
  evaluator's ragged numpy lists (boxes, 1-based classes, scores).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from transoar_tpu_torch.models.attn_fpn import AttnFPN
from transoar_tpu_torch.models.criterion import loss_segmentation
from transoar_tpu_torch.models.focused_decoder import level_spatial_shape
from transoar_tpu_torch.ops.conv3d import Conv3d
from transoar_tpu_torch.ops.nms import nms_3d
from transoar_tpu_torch.utils.boxes import (box_cxcyczwhd_to_xyzxyz,
                                            box_iou_pairwise,
                                            generalized_box_iou_elementwise)
from transoar_tpu_torch.utils.spans import span

# focal-loss prior: P(fg) ~ 0.01 at init
PRIOR_BIAS = float(-np.log((1 - 0.01) / 0.01))


def generate_level_anchors(patch_size, level, scales, ratios):
    """Anchors for one P-level: [S_l * K, 6] normalized cxcyczwhd.

    ``scales``: base sizes in voxels at the input resolution.
    ``ratios``: per-axis multiplier triples.
    """
    shape = level_spatial_shape(patch_size, level)
    stride = 2 ** level
    patch = np.asarray(patch_size, np.float64)

    centers = np.stack(np.meshgrid(
        *[(np.arange(s) + 0.5) * stride for s in shape], indexing="ij"),
        axis=-1).reshape(-1, 3) / patch  # [S_l, 3] normalized

    sizes = []
    for scale in scales:
        for ratio in ratios:
            sizes.append(np.asarray(ratio, np.float64) * scale / patch)
    sizes = np.stack(sizes)  # [K, 3]

    anchors = np.concatenate([
        np.repeat(centers, len(sizes), axis=0),
        np.tile(sizes, (len(centers), 1)),
    ], axis=-1)
    return anchors.astype(np.float32)


def build_anchors(config):
    """All-level anchors [A, 6] + per-level counts."""
    rcfg = config["retina"]
    patch = config["augmentation"]["patch_size"]
    anchors, counts = [], []
    for level in rcfg["levels"]:
        a = generate_level_anchors(patch, int(level[-1]),
                                   rcfg["anchor_scales"],
                                   rcfg["anchor_ratios"])
        anchors.append(a)
        counts.append(len(a))
    return np.concatenate(anchors), counts


def encode_deltas(boxes, anchors):
    """cxcyczwhd boxes -> regression targets relative to anchors."""
    d_center = (boxes[..., :3] - anchors[..., :3]) / anchors[..., 3:]
    d_size = torch.log(boxes[..., 3:].clamp_min(1e-6) / anchors[..., 3:])
    return torch.cat([d_center, d_size], dim=-1)


def decode_deltas(deltas, anchors):
    centers = anchors[..., :3] + deltas[..., :3] * anchors[..., 3:]
    sizes = anchors[..., 3:] * torch.exp(deltas[..., 3:].clamp(-6, 6))
    return torch.cat([centers, sizes], dim=-1)


class ConvTower(nn.Module):
    """``depth`` 3x3x3 convs + ReLU (``conv{i}``), then the ``out`` conv."""

    def __init__(self, in_channels: int, depth: int, features: int,
                 out_features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"conv{i}", Conv3d(
                in_channels if i == 0 else features, features, 3,
                dtype=dtype))
        self.out = Conv3d(features if depth else in_channels, out_features, 3,
                          dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return self.out(x)


class RetinaNet(nn.Module):
    """Backbone FPN + shared cls/reg towers over ``retina.levels``."""

    def __init__(self, config: Dict[str, Any], anchors: np.ndarray,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        backbone = config["backbone"]
        rcfg = config["retina"]
        self.levels = list(rcfg["levels"])
        self.num_classes = config["neck"]["num_organs"]
        K = len(rcfg["anchor_scales"]) * len(rcfg["anchor_ratios"])
        depth = rcfg.get("tower_depth", 4)
        width = rcfg.get("tower_channels", 128)
        fpn = backbone["fpn_channels"]
        self._backbone = AttnFPN(backbone, dtype,
                                 config["augmentation"]["patch_size"])
        self._cls_tower = ConvTower(fpn, depth, width, K * self.num_classes,
                                    dtype)
        self._reg_tower = ConvTower(fpn, depth, width, K * 6, dtype)
        if backbone.get("use_seg_proxy_loss"):
            self._seg_head = Conv3d(
                backbone["start_channels"],
                2 if backbone.get("fg_bg", True) else self.num_classes + 1,
                1, dtype=dtype)
        self.register_buffer("anchors", torch.as_tensor(
            anchors, dtype=torch.float32), persistent=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX model's initialisers: lecun-normal convs with zero
        biases, the class tower's ``out`` bias at the focal prior."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        with torch.no_grad():
            self._cls_tower.out.bias.fill_(PRIOR_BIAS)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """x [B, S0, S1, S2, C_in] -> anchor_logits [B, A, C],
        anchor_deltas [B, A, 6] and, with the seg proxy, pred_seg
        [B, S0, S1, S2, K]; all f32."""
        feats = self._backbone(x, generator)
        B = x.shape[0]
        levels = [self._backbone.whole(feats[lv], lv) for lv in self.levels]
        with span("model.cls_tower"):
            logits = [self._cls_tower(f).reshape(B, -1, self.num_classes)
                      for f in levels]
        with span("model.reg_tower"):
            deltas = [self._reg_tower(f).reshape(B, -1, 6) for f in levels]
        out = {"anchor_logits": torch.cat(logits, 1).float(),
               "anchor_deltas": torch.cat(deltas, 1).float()}
        if hasattr(self, "_seg_head"):
            with span("model.seg_head"):
                out["pred_seg"] = self._backbone.whole(
                    self._seg_head(feats["P0"]).float(), "P0")
        return out


def build_retinanet(config, dtype: Optional[torch.dtype] = None,
                    device=None, generator: Optional[torch.Generator] = None):
    """The RetinaNet of ``config`` with its anchors, parameters drawn from
    ``generator``, on ``device``; ``dtype`` defaults to the config's
    ``trainer.precision``."""
    if dtype is None:
        precision = config.get("trainer", {}).get("precision", "bfloat16")
        dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    anchors, _ = build_anchors(config)
    model = RetinaNet(config, anchors, dtype)
    model.reset_parameters(generator)
    return model if device is None else model.to(device)


def sigmoid_focal_loss(logits, targets, alpha=0.25, gamma=2.0):
    """Elementwise focal loss (RetinaNet)."""
    p = torch.sigmoid(logits)
    ce = logits.clamp_min(0) - logits * targets + torch.log1p(
        torch.exp(-logits.abs()))
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * (1 - p_t) ** gamma * ce


class RetinaCriterion:
    """Max-IoU assignment + focal / L1 / GIoU losses; holds only static
    config."""

    def __init__(self, config):
        rcfg = config["retina"]
        self.num_classes = config["neck"]["num_organs"]
        self.pos_iou = rcfg.get("pos_iou", 0.5)
        self.neg_iou = rcfg.get("neg_iou", 0.4)
        self.alpha = rcfg.get("focal_alpha", 0.25)
        self.gamma = rcfg.get("focal_gamma", 2.0)
        self.seg_proxy = bool(config["backbone"].get("use_seg_proxy_loss"))
        self.fg_bg = bool(config["backbone"].get("fg_bg", True))

    @staticmethod
    @torch.no_grad()
    def assign(tgt_boxes, present, anchors):
        """(best GT index, its IoU) [B, A] of every anchor over the present
        boxes (IoU -1 against an absent one)."""
        iou, _ = box_iou_pairwise(box_cxcyczwhd_to_xyzxyz(anchors),
                                  box_cxcyczwhd_to_xyzxyz(tgt_boxes))
        iou = torch.where(present[:, None, :], iou, -1.0)  # [B, A, G]
        best_iou, best_gt = iou.max(-1)
        return best_gt, best_iou

    def batch_normalizer(self, targets, anchors):
        """The batch's positive-anchor count (f32): summed over the dp
        ranks, the ``present_total`` of the global batch."""
        _, best_iou = self.assign(targets["boxes"].float(),
                                  targets["present"], anchors)
        return (best_iou >= self.pos_iou).sum().float()

    def __call__(self, outputs, targets, anchors, present_total=None,
                 group=None) -> Dict[str, torch.Tensor]:
        """anchors [A, 6] cxcyczwhd; targets boxes [B, G, 6] + present;
        ``present_total``: ``batch_normalizer`` of the global batch;
        ``group``: the dp group of the seg proxy's terms."""
        logits = outputs["anchor_logits"]  # [B, A, C]
        deltas = outputs["anchor_deltas"]  # [B, A, 6]
        tgt_boxes = targets["boxes"].float()
        C = logits.shape[-1]
        best_gt, best_iou = self.assign(tgt_boxes, targets["present"],
                                        anchors)
        pos = best_iou >= self.pos_iou  # [B, A]
        valid = pos | (best_iou < self.neg_iou)  # the rest is ignored

        classes = torch.arange(C, device=logits.device)
        cls_t = ((best_gt[..., None] == classes) & pos[..., None]).float()
        focal = sigmoid_focal_loss(logits, cls_t, self.alpha, self.gamma)
        num_pos = (pos.sum().float() if present_total is None
                   else present_total).clamp_min(1.0)
        loss_cls = torch.where(valid[..., None], focal, 0.0).sum() / num_pos

        matched = tgt_boxes.gather(
            1, best_gt[..., None].expand(-1, -1, 6))  # [B, A, 6]
        tgt_deltas = encode_deltas(matched, anchors[None])
        l1 = (deltas - tgt_deltas).abs().sum(-1)
        loss_bbox = torch.where(pos, l1, 0.0).sum() / num_pos

        decoded = decode_deltas(deltas, anchors[None])
        giou = generalized_box_iou_elementwise(
            box_cxcyczwhd_to_xyzxyz(decoded.clamp(0.0, 1.0)),
            box_cxcyczwhd_to_xyzxyz(matched))
        loss_giou = torch.where(pos, 1.0 - giou, 0.0).sum() / num_pos

        zero = torch.zeros((), device=logits.device)
        losses = {"cls": loss_cls, "bbox": loss_bbox, "giou": loss_giou,
                  "segce": zero, "segdice": zero}
        if self.seg_proxy and "pred_seg" in outputs:
            losses["segce"], losses["segdice"] = loss_segmentation(
                outputs["pred_seg"], targets["seg"], self.fg_bg, group)
        return losses


@torch.no_grad()
def retina_inference(outputs, anchors, num_classes, iou_threshold=0.5,
                     max_out=50, score_threshold=0.05, candidates=500):
    """Decode + per-volume, per-class NMS -> ragged numpy lists matching the
    evaluator interface (boxes [n, 6] cxcyczwhd, classes 1-based, scores),
    one entry per volume. ``outputs`` hold tensors on any device; the work
    runs there and one copy brings the kept slots to the host."""
    logits = outputs["anchor_logits"]
    deltas = outputs["anchor_deltas"].float()
    anchors = torch.as_tensor(anchors, dtype=torch.float32,
                              device=logits.device)
    B, A, C = logits.shape
    k = min(candidates, A)
    scores, top = torch.sigmoid(logits.float()).topk(k, dim=1)  # [B, k, C]
    scores, top = scores.transpose(1, 2), top.transpose(1, 2)  # [B, C, k]
    flat = top.reshape(B, C * k, 1).expand(-1, -1, 6)
    decoded = decode_deltas(deltas.gather(1, flat),
                            anchors[top.reshape(B, C * k)])
    decoded = decoded.view(B, C, k, 6)
    keep, valid = nms_3d(box_cxcyczwhd_to_xyzxyz(decoded), scores,
                         iou_threshold=iou_threshold, max_out=max_out,
                         score_threshold=score_threshold)  # [B, C, M]
    slot = keep.clamp_min(0)
    boxes = decoded.gather(2, slot[..., None].expand(-1, -1, -1, 6))
    kept_scores = scores.gather(2, slot)
    boxes, kept_scores, valid = (t.cpu().numpy() for t in
                                 (boxes, kept_scores, valid))

    all_boxes, all_classes, all_scores = [], [], []
    labels = np.broadcast_to(np.arange(1, C + 1)[:, None], valid.shape[1:])
    for b in range(B):
        v = valid[b]
        all_boxes.append(boxes[b][v])
        all_classes.append(labels[v].astype(np.int64))
        all_scores.append(kept_scores[b][v])
    return all_boxes, all_classes, all_scores

