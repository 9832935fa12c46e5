"""3D bounding-box utilities: torch twins of ``transoar_tpu/utils/boxes.py``.

Boxes live in the array-axis order of the volume (coordinate 0 indexes
spatial axis 0). Corner format is ``(x1, y1, z1, x2, y2, z2)``, center
format ``(cx, cy, cz, w, h, d)``, normalized to [0, 1].

- Format changes, volumes, pairwise and elementwise IoU/GIoU: torch on any
  device (the GIoU adds ``eps`` to the enclosing volume, as the JAX side).
- ``segmentation2bbox``: fixed-shape per-class boxes from a label batch, on
  the device of the labels (the train step's targets).
- ``box_iou_np`` and ``segmentation2bbox_np``: numpy copies for the
  evaluator and the synthetic dataset.
"""

from __future__ import annotations

import numpy as np
import torch


def box_cxcyczwhd_to_xyzxyz(boxes):
    """Center format -> corner format, [..., 6] (torch or numpy)."""
    c, s = boxes[..., :3], boxes[..., 3:]
    if isinstance(boxes, torch.Tensor):
        return torch.cat([c - 0.5 * s, c + 0.5 * s], dim=-1)
    return np.concatenate([c - 0.5 * s, c + 0.5 * s], axis=-1)


def box_xyzxyz_to_cxcyczwhd(boxes):
    """Corner format -> center format, [..., 6] (torch or numpy)."""
    lo, hi = boxes[..., :3], boxes[..., 3:]
    if isinstance(boxes, torch.Tensor):
        return torch.cat([(lo + hi) * 0.5, hi - lo], dim=-1)
    return np.concatenate([(lo + hi) * 0.5, hi - lo], axis=-1)


def box_volume(boxes):
    """Volume of corner-format boxes [..., 6] -> [...]."""
    d = boxes[..., 3:] - boxes[..., :3]
    return d[..., 0] * d[..., 1] * d[..., 2]


def _clipped_volume(lo, hi):
    d = (hi - lo).clamp_min(0.0)
    return d[..., 0] * d[..., 1] * d[..., 2]


def box_iou_pairwise(boxes1, boxes2, eps=0.0):
    """boxes1 [..., N, 6], boxes2 [..., M, 6] (corners) ->
    (iou [..., N, M], union [..., N, M])."""
    v1, v2 = box_volume(boxes1), box_volume(boxes2)
    inter = _clipped_volume(
        torch.maximum(boxes1[..., :, None, :3], boxes2[..., None, :, :3]),
        torch.minimum(boxes1[..., :, None, 3:], boxes2[..., None, :, 3:]))
    union = v1[..., :, None] + v2[..., None, :] - inter
    return inter / (union + eps), union


def generalized_box_iou_pairwise(boxes1, boxes2, eps=1e-7):
    """Pairwise 3D GIoU, iou - (enclosing - union) / (enclosing + eps)."""
    iou, union = box_iou_pairwise(boxes1, boxes2, eps=eps)
    vol = _clipped_volume(
        torch.minimum(boxes1[..., :, None, :3], boxes2[..., None, :, :3]),
        torch.maximum(boxes1[..., :, None, 3:], boxes2[..., None, :, 3:]))
    return iou - (vol - union) / (vol + eps)


def box_iou_elementwise(boxes1, boxes2, eps=0.0):
    """IoU of same-shape corner boxes [..., 6] -> (iou, union) [...]."""
    v1, v2 = box_volume(boxes1), box_volume(boxes2)
    inter = _clipped_volume(torch.maximum(boxes1[..., :3], boxes2[..., :3]),
                            torch.minimum(boxes1[..., 3:], boxes2[..., 3:]))
    union = v1 + v2 - inter
    return inter / (union + eps), union


def generalized_box_iou_elementwise(boxes1, boxes2, eps=1e-7):
    """GIoU of same-shape corner boxes [..., 6] -> [...]."""
    iou, union = box_iou_elementwise(boxes1, boxes2, eps=eps)
    vol = _clipped_volume(torch.minimum(boxes1[..., :3], boxes2[..., :3]),
                          torch.maximum(boxes1[..., 3:], boxes2[..., 3:]))
    return iou - (vol - union) / (vol + eps)


def segmentation2bbox(seg, num_classes, padding=1, min_extent=5,
                      normalize=True):
    """Per-class boxes of an integer label batch, on its device.

    seg [B, S0, S1, S2] (0 = background; class c fills slot c - 1) ->
    boxes [B, num_classes, 6] f32 (cxcyczwhd, normalized if ``normalize``,
    zero where absent) and present [B, num_classes] bool (the class occurs
    and spans at least ``min_extent`` voxels along every axis). The box is
    the voxel-index extent, ``padding`` voxels wider on each side, clipped
    to the volume.

    Computed per axis from the class's occupancy of each slice (a one-hot
    any() over the other two axes), which gives the same extents as the JAX
    side's masked min/max over the whole one-hot volume.
    """
    if seg.dim() != 4:
        raise ValueError(f"expected [B, S0, S1, S2] labels, got "
                         f"{tuple(seg.shape)}")
    B, spatial = seg.shape[0], seg.shape[1:]
    big = torch.tensor(spatial, dtype=torch.float32, device=seg.device)
    cls_ids = torch.arange(1, num_classes + 1, device=seg.device)
    onehot = seg.long()[:, None] == cls_ids[None, :, None, None, None]

    lo, hi = [], []
    for axis in range(3):
        others = tuple(2 + a for a in range(3) if a != axis)
        occupied = onehot.any(dim=others)                    # [B, C, S_axis]
        idx = torch.arange(spatial[axis], dtype=torch.float32,
                           device=seg.device)
        lo.append(torch.where(occupied, idx, big[axis]).amin(-1))
        hi.append(torch.where(occupied, idx, -1.0).amax(-1))
    lo, hi = torch.stack(lo, -1), torch.stack(hi, -1)       # [B, C, 3]

    present = (hi >= 0).all(-1) & ((hi - lo) >= min_extent).all(-1)
    lo = (lo - padding).clamp_min(0.0)
    hi = torch.minimum(hi + padding, big)
    if normalize:
        lo, hi = lo / big, hi / big
    boxes = torch.cat([(lo + hi) * 0.5, hi - lo], dim=-1)
    return torch.where(present[..., None], boxes, 0.0), present


# ---------------------------------------------------------------------------
# numpy copies for the host-side evaluator and the synthetic dataset
# ---------------------------------------------------------------------------

def box_iou_np(boxes1, boxes2, box_format="cxcyczwhd"):
    """Pairwise IoU on numpy arrays [N, 6] x [M, 6] -> [N, M]."""
    if box_format == "cxcyczwhd":
        boxes1 = box_cxcyczwhd_to_xyzxyz(np.asarray(boxes1))
        boxes2 = box_cxcyczwhd_to_xyzxyz(np.asarray(boxes2))

    d1 = boxes1[:, 3:] - boxes1[:, :3]
    d2 = boxes2[:, 3:] - boxes2[:, :3]
    v1 = d1[:, 0] * d1[:, 1] * d1[:, 2]
    v2 = d2[:, 0] * d2[:, 1] * d2[:, 2]

    lo = np.maximum(boxes1[:, None, :3], boxes2[None, :, :3])
    hi = np.minimum(boxes1[:, None, 3:], boxes2[None, :, 3:])
    delta = np.clip(hi - lo, 0, None)
    inter = delta[..., 0] * delta[..., 1] * delta[..., 2]
    union = v1[:, None] + v2[None, :] - inter
    return inter / union


def segmentation2bbox_np(seg, padding=1, min_extent=5, normalize=True,
                         box_format="cxcyczwhd"):
    """Host-side ragged variant: (boxes [K, 6], classes [K]) of the classes
    present in one [S0, S1, S2] label volume."""
    seg = np.asarray(seg)
    assert seg.ndim == 3, f"expected [S0, S1, S2], got {seg.shape}"
    shape = np.array(seg.shape, dtype=np.float32)

    boxes, classes = [], []
    for cls in np.unique(seg):
        if cls == 0:
            continue
        idx = np.stack(np.nonzero(seg == cls), axis=-1).astype(np.float32)
        lo, hi = idx.min(axis=0), idx.max(axis=0)
        if ((hi - lo) < min_extent).any():
            continue
        lo = np.clip(lo - padding, 0, None)
        hi = np.minimum(hi + padding, shape)
        if normalize:
            lo, hi = lo / shape, hi / shape
        if box_format == "cxcyczwhd":
            boxes.append(np.concatenate([(lo + hi) / 2, hi - lo]))
        else:
            boxes.append(np.concatenate([lo, hi]))
        classes.append(int(cls))
    if boxes:
        return np.stack(boxes), np.array(classes)
    return np.zeros((0, 6), np.float32), np.zeros((0,), np.int64)
