"""Visualization exports: .ply point clouds / bbox wireframes + attention
maps (the port's copy of ``transoar_tpu/utils/visualization.py``, the same
numpy code; ``tests/test_torch_copies.py`` pins the files it writes).

Counterpart of reference ``transoar/utils/visualization.py`` (which depends
on open3d + cv2): pure numpy, with PIL and scipy imported where used.

- ``save_pred_visualization``: exports the case's segmentation voxels as a
  colored point cloud plus prediction (red) and ground-truth (green) bbox
  wireframes as ASCII .ply (reference visualization.py:145-214, 310-454).
- ``save_attn_visualization``: exports per-organ decoder cross-attention
  maps as PNG slices (reference visualization.py:222-308).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from transoar_tpu_torch.utils.boxes import box_cxcyczwhd_to_xyzxyz

_PALETTE = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
    [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128],
], np.uint8)


def write_ply(path, verts, colors=None, edges=None):
    """ASCII .ply with vertices, per-vertex colors, and optional edges."""
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    if colors is None:
        colors = np.zeros_like(verts, dtype=np.uint8)
    colors = np.asarray(colors, np.uint8).reshape(-1, 3)
    edges = [] if edges is None else list(edges)

    lines = [
        "ply", "format ascii 1.0",
        f"element vertex {len(verts)}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        f"element edge {len(edges)}",
        "property int vertex1", "property int vertex2",
        "end_header",
    ]
    for v, c in zip(verts, colors):
        lines.append(f"{v[0]:.4f} {v[1]:.4f} {v[2]:.4f} "
                     f"{int(c[0])} {int(c[1])} {int(c[2])}")
    for a, b in edges:
        lines.append(f"{int(a)} {int(b)}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")


_BOX_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7),
              (6, 7), (0, 4), (1, 5), (2, 6), (3, 7)]


def bbox_wireframe(box_corner, scale):
    """8 corner vertices of a normalized corner-format box, in voxel units."""
    lo, hi = box_corner[:3] * scale, box_corner[3:] * scale
    verts = np.array([[x, y, z]
                      for x in (lo[0], hi[0])
                      for y in (lo[1], hi[1])
                      for z in (lo[2], hi[2])], np.float32)
    return verts, _BOX_EDGES


def save_pred_visualization(pred_boxes, pred_classes, pred_scores, gt_boxes,
                            gt_classes, seg, out_dir, case_id):
    """Write ``case_<id>_{seg,pred,gt}.ply`` for external viewers."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shape = np.asarray(seg.shape, np.float32)

    # segmentation point cloud (subsampled)
    idx = np.stack(np.nonzero(seg), -1)
    if len(idx):
        sub = idx[::max(len(idx) // 50000, 1)]
        cls = seg[tuple(sub.T)].astype(int)
        colors = _PALETTE[(cls - 1) % len(_PALETTE)]
        write_ply(out_dir / f"case_{case_id}_seg.ply", sub.astype(np.float32),
                  colors)

    def boxes_to_ply(boxes, classes, path, color):
        verts_all, edges_all = [], []
        for box in np.asarray(boxes).reshape(-1, 6):
            corner = box_cxcyczwhd_to_xyzxyz(box)
            verts, edges = bbox_wireframe(corner, shape)
            base = sum(len(v) for v in verts_all)
            verts_all.append(verts)
            edges_all.extend([(a + base, b + base) for a, b in edges])
        if verts_all:
            verts = np.concatenate(verts_all)
            colors = np.tile(np.asarray(color, np.uint8), (len(verts), 1))
            write_ply(path, verts, colors, edges_all)

    boxes_to_ply(pred_boxes, pred_classes,
                 out_dir / f"case_{case_id}_pred.ply", [255, 0, 0])
    boxes_to_ply(gt_boxes, gt_classes,
                 out_dir / f"case_{case_id}_gt.ply", [0, 255, 0])


def _red_alpha_png(alpha_2d, path):
    """RGBA PNG with solid red and the given [H, W] 0-255 alpha — the
    reference's cv2.merge((0, 0, 255, alpha)) export format
    (visualization.py:241-247,318-324)."""
    from PIL import Image

    alpha = np.clip(alpha_2d, 0, 255).astype(np.uint8)
    rgba = np.zeros((*alpha.shape, 4), np.uint8)
    rgba[..., 0] = 255
    rgba[..., 3] = alpha
    Image.fromarray(rgba, "RGBA").save(path)


def save_attn_visualization(model_out, config, out_dir, case_id, seg=None,
                            mean_attn=True):
    """Per-organ attention-map export, mirroring reference
    ``save_attn_visualization`` (visualization.py:222-308):

    - decoder SELF-attention [Q, Q] block-summed per organ ->
      ``case{id}_cdist.png`` (organ-by-organ affinity, red-alpha, 1000x1000);
    - decoder CROSS-attention of each organ's best-scoring query, reshaped
      to the feature-map grid, upsampled to the volume shape, exported as
      every-5th-frame red-alpha overlays next to recolored segmentation
      frames (own organ 240, other organs 50) under ``class<k>/``.

    model_out: dict with ``attn_weights`` [B, H, Q, S],
    ``self_attn_weights`` [B, Q, Q], ``pred_logits`` [B, Q, 1];
    seg: [S0, S1, S2] int labels of the case (optional).
    """
    from PIL import Image
    from scipy import ndimage

    from transoar_tpu_torch.models.focused_decoder import \
        level_spatial_shape

    out_dir = Path(out_dir) / f"case{case_id}"
    out_dir.mkdir(parents=True, exist_ok=True)

    neck = config["neck"]
    patch = config["augmentation"]["patch_size"]
    shape = level_spatial_shape(patch, int(neck["input_levels"][-1]))
    num_organs = neck["num_organs"]
    qpo = neck["num_queries"] // num_organs

    # --- self-attention organ affinity (visualization.py:231-247) ---
    self_w = model_out.get("self_attn_weights")
    if self_w is not None:
        sw = np.asarray(self_w[0], np.float32)  # [Q, Q]
        blocks = sw.reshape(num_organs, qpo, num_organs, qpo).sum((1, 3))
        lo, hi = blocks.min(), blocks.max()
        blocks = (blocks - lo) / (hi - lo + 1e-12) * 255
        img = np.asarray(Image.fromarray(blocks.astype(np.uint8)).resize(
            (1000, 1000), Image.NEAREST))
        _red_alpha_png(img, out_dir / f"case{case_id}_cdist.png")

    # --- cross-attention overlays (visualization.py:250-308) ---
    attn = np.asarray(model_out["attn_weights"][0], np.float32)
    if attn.ndim == 3:  # focused branch: [H, Q, S] -> head average
        attn = attn.mean(0)
    logits = np.asarray(model_out["pred_logits"][0], np.float32)
    if logits.shape[-1] > 1:
        # DETR branch: generic queries + softmax classes (no organ/qpo
        # block structure) — per organ, take the query most confident in
        # that class
        e = np.exp(logits - logits.max(-1, keepdims=True))
        probs = e / e.sum(-1, keepdims=True)  # [Q, K+1]
        attn = attn.reshape(attn.shape[0], *shape)  # [Q, *shape]
        best_query = probs[:, 1:num_organs + 1].argmax(0)  # [num_organs]
        organ_vols = attn[best_query]
    else:
        attn = attn.reshape(num_organs, qpo, *shape)
        logits = logits.reshape(num_organs, qpo)
        organ_vols = attn[np.arange(num_organs), logits.argmax(-1)]

    for organ in range(num_organs):
        vol = organ_vols[organ]
        zoom = [p / s for p, s in zip(patch, vol.shape)]
        vol = ndimage.zoom(vol, zoom, order=1)
        lo, hi = vol.min(), vol.max()
        vol = (vol - lo) / (hi - lo + 1e-12) * 255
        # frames along axis 1, like the reference's permute (1, 0, 2)
        vol = np.transpose(vol, (1, 0, 2))

        organ_dir = out_dir / f"class{organ + 1}"
        organ_dir.mkdir(exist_ok=True)

        seg_frames = None
        if seg is not None:
            seg_r = np.asarray(seg).astype(np.int16).copy()
            own = seg_r == organ + 1
            seg_r[(seg_r > 0) & ~own] = 50
            seg_r[own] = 240
            seg_frames = np.transpose(seg_r, (1, 0, 2))

        if mean_attn:
            frame = vol.mean(axis=0)
            lo, hi = frame.min(), frame.max()
            # divisor is hi, not (hi - lo): deliberately reproduces the
            # reference's normalization (visualization.py:300 divides the
            # shifted frame by attn_map.max()), so mean-attn exports match
            frame = (frame - lo) / (hi + 1e-12) * 255

        for idx in range(0, vol.shape[0], 5):
            attn_frame = frame if mean_attn else vol[idx]
            _red_alpha_png(attn_frame, organ_dir / f"frame{idx}_attn.png")
            if seg_frames is not None:
                rgb = np.repeat(
                    seg_frames[idx].astype(np.uint8)[..., None], 3, -1)
                Image.fromarray(rgb, "RGB").save(
                    organ_dir / f"frame{idx}_seg.png")
