"""Greedy 3D non-maximum suppression with fixed shapes (port of
``transoar_tpu/ops/nms.py``), stock torch ops on the tensor's device.

``max_out`` rounds of (argmax over the live scores) + (suppress every box
whose IoU with the chosen one exceeds the threshold, and the chosen box
itself); no host sync and no data-dependent shape inside the rounds. Any
leading dimensions are independent problems suppressed in the same rounds,
so one call runs every class of every volume. Outputs are fixed-size index
and validity arrays; consumers mask by ``valid``.

Ties: each round takes the first maximal score in index order
(``torch.argmax``, as ``jnp.argmax``).
"""

from __future__ import annotations

import torch

from transoar_tpu_torch.utils.boxes import box_iou_pairwise

NEG = -1e9


def nms_3d(boxes, scores, iou_threshold=0.5, max_out=100,
           score_threshold=None):
    """Greedy NMS on corner-format boxes.

    boxes [..., N, 6] (x1, y1, z1, x2, y2, z2), scores [..., N] ->
    (keep_idx [..., max_out] int64, -1 in unused slots; valid
    [..., max_out] bool). Scores below ``score_threshold`` never survive.
    """
    *lead, N, _ = boxes.shape
    boxes = boxes.reshape(-1, N, 6)
    live = scores.reshape(-1, N).float()
    if score_threshold is not None:
        live = torch.where(live >= score_threshold, live, NEG)
    iou, _ = box_iou_pairwise(boxes, boxes)  # [M, N, N]
    M = boxes.shape[0]
    keep = torch.full((M, max_out), -1, dtype=torch.long,
                      device=boxes.device)
    valid = torch.zeros((M, max_out), dtype=torch.bool, device=boxes.device)
    rows = torch.arange(M, device=boxes.device)
    cols = torch.arange(N, device=boxes.device)
    for i in range(min(max_out, N)):
        best = live.argmax(-1)
        ok = live[rows, best] > NEG / 2
        keep[:, i] = torch.where(ok, best, -1)
        valid[:, i] = ok
        suppress = (iou[rows, best] > iou_threshold) | (cols == best[:, None])
        live = torch.where(ok[:, None] & suppress, NEG, live)
    return keep.reshape(*lead, max_out), valid.reshape(*lead, max_out)


def batched_class_nms(boxes, scores, classes, iou_threshold=0.5,
                      max_out=100, score_threshold=None):
    """Per-class NMS over one box set: each class's boxes are offset into a
    disjoint region, so cross-class pairs never overlap (as the JAX
    function). ``nms_3d`` with a leading class dimension does the same
    without the offsets."""
    shifted = boxes + classes.to(boxes.dtype)[..., None] * 2.0
    return nms_3d(shifted, scores, iou_threshold, max_out, score_threshold)
