"""Synthetic dataset generation for tests and benchmarks (copy of
``transoar_tpu/data/synthetic.py``; the tests pin it to the original).

The reference ships no data. This module fabricates a structurally
faithful preprocessed dataset — ellipsoidal "organs" at statistically
consistent positions, plus the ``data_info.json`` the config system merges
(bbox_properties with attn_area, shape/voxel statistics) — so the full
train/eval path runs end to end without a download.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from transoar_tpu_torch.models.anchors import synthetic_bbox_props
from transoar_tpu_torch.utils.boxes import segmentation2bbox_np
from transoar_tpu_torch.utils.io import write_json


def make_case(rng, shape, bbox_props, noise=0.1):
    """One synthetic (image, label) pair following per-class priors.

    Each ellipsoid is drawn inside its bounding box (plus one voxel), where
    the distance is summed per axis in the original's order: the same bits
    as the full-grid original, without its pass over the whole volume per
    organ."""
    shape = np.asarray(shape)
    label = np.zeros(shape, np.int32)

    for cls_str, props in bbox_props.items():
        cls = int(cls_str)
        median = np.asarray(props["median"])
        jitter = rng.normal(scale=0.02, size=3)
        center = np.clip(median[:3] + jitter, 0.1, 0.9) * shape
        radius = np.maximum(median[3:] * shape / 2
                            * rng.uniform(0.85, 1.15, 3), 3.5)
        lo = np.clip(np.floor(center - radius).astype(int) - 1, 0, shape)
        hi = np.clip(np.ceil(center + radius).astype(int) + 2, 0, shape)
        terms = [((np.arange(lo[a], hi[a], dtype=np.float64) - center[a])
                  / radius[a]) ** 2 for a in range(3)]
        dist = (terms[0][:, None, None] + terms[1][None, :, None]
                + terms[2][None, None, :])
        box = tuple(slice(lo[a], hi[a]) for a in range(3))
        label[box] = np.where(dist <= 1.0, cls, label[box])

    image = (label > 0).astype(np.float32)
    image += rng.normal(scale=noise, size=shape).astype(np.float32)
    image += label.astype(np.float32) * 0.05
    return image.astype(np.float32), label


def generate_dataset(root, name="synthetic", shape=(64, 64, 32),
                     num_classes=6, num_train=8, num_val=4, num_test=4,
                     seed=0):
    """Write a preprocessed dataset tree + data_info.json; returns its path."""
    rng = np.random.default_rng(seed)
    priors = synthetic_bbox_props(num_classes, seed=seed)

    root = Path(root)
    ds_dir = root / name
    splits = {"train": num_train, "val": num_val, "test": num_test}

    all_boxes = {c: [] for c in range(1, num_classes + 1)}
    voxels = []
    for split, count in splits.items():
        for i in range(count):
            image, label = make_case(rng, shape, priors)
            case_dir = ds_dir / split / f"case_{split}_{i:03d}"
            case_dir.mkdir(parents=True, exist_ok=True)
            np.save(case_dir / "data.npy", image)
            np.save(case_dir / "label.npy", label)
            if split != "test":
                boxes, classes = segmentation2bbox_np(label, padding=1)
                for box, cls in zip(boxes, classes):
                    all_boxes[int(cls)].append(box)
                fg = image[label > 0]
                voxels.append(fg[::10])

    bbox_properties = {}
    for cls, boxes in all_boxes.items():
        if not boxes:
            continue
        arr = np.stack(boxes)
        corners = np.concatenate(
            [arr[:, :3] - arr[:, 3:] / 2, arr[:, :3] + arr[:, 3:] / 2], -1)
        bbox_properties[str(cls)] = {
            "median": np.median(arr, 0).tolist(),
            "mean": arr.mean(0).tolist(),
            "min": arr.min(0).tolist(),
            "max": arr.max(0).tolist(),
            "percentile_99_5": np.percentile(arr, 99.5, 0).tolist(),
            "percentile_00_5": np.percentile(arr, 0.5, 0).tolist(),
            "attn_area": np.concatenate(
                [corners[:, :3].min(0), corners[:, 3:].max(0)]).tolist(),
        }

    voxels = np.concatenate(voxels) if voxels else np.zeros(1, np.float32)
    data_info = {
        "num_classes": num_classes,
        "labels": {str(c): f"organ{c}" for c in range(1, num_classes + 1)},
        "labels_small": {"1": "organ1"},
        "labels_mid": {str(c): f"organ{c}"
                       for c in range(2, num_classes)},
        "labels_large": {str(num_classes): f"organ{num_classes}"},
        "bbox_properties": bbox_properties,
        "shape_statistics": {
            "median": list(shape), "mean": list(shape), "min": list(shape),
            "max": list(shape),
            "percentile_99_5": list(shape), "percentile_00_5": list(shape),
        },
        "foreground_voxel_statistics": {
            "median": float(np.median(voxels)),
            "mean": float(voxels.mean()),
            "std": float(voxels.std()),
            "min": float(voxels.min()),
            "max": float(voxels.max()),
            "percentile_99_5": float(np.percentile(voxels, 99.5)),
            "percentile_00_5": float(np.percentile(voxels, 0.5)),
        },
    }
    write_json(data_info, ds_dir / "data_info.json")
    return ds_dir
