"""Offline preprocessing: raw NIfTI cases -> fixed-shape .npy + dataset
statistics (data_info.json). The port's copy of
``transoar_tpu/data/preprocessor.py`` (the same numpy + scipy code;
``tests/test_torch_copies.py`` pins its files bit for bit).

Re-design of reference ``transoar/data/preprocessor_amos.py`` /
``preprocessor_visceral.py`` without MONAI/SimpleITK (pure numpy + scipy):

Pipeline per case (reference transforms.py:37-75):
  load NIfTI -> reorient RAS -> crop to the foreground of selected organs
  (AMOS: border organs {1, 6, 7, 14, 15} with margin 2, transforms.py:29-32;
  VISCERAL: all foreground, margin from config) -> resize to the fixed shape
  (image: linear "area"-style, label: nearest).

Case filters (AMOS, preprocessor_amos.py:68-94): skip cases missing border
organs or whose border organs touch the volume boundary. VISCERAL
(preprocessor_visceral.py:65-67): skip cases with fewer than
``min_num_organs`` labels.

Statistics collected over train+val (preprocessor_amos.py:96-120):
per-class bbox stats (median/mean/min/max/percentiles + ``attn_area`` =
union of class boxes — the atlas that drives anchors and attention masks),
shape statistics, and foreground-voxel intensity percentiles (every 10th
voxel).
"""

from __future__ import annotations

import logging
from collections import defaultdict
from pathlib import Path

import numpy as np
from scipy import ndimage

from transoar_tpu_torch.data.nifti import load_nifti, reorient_ras
from transoar_tpu_torch.utils.boxes import (box_cxcyczwhd_to_xyzxyz,
                                            segmentation2bbox_np)
from transoar_tpu_torch.utils.io import write_json

logger = logging.getLogger(__name__)


def resize_volume(volume, target_shape, order):
    """Resize with scipy zoom; order=1 ~ linear (image), order=0 = nearest
    (labels)."""
    factors = [t / s for t, s in zip(target_shape, volume.shape)]
    out = ndimage.zoom(volume, factors, order=order, mode="nearest",
                       grid_mode=True)
    # zoom can be off by one voxel; crop/pad to the exact target
    slices = tuple(slice(0, t) for t in target_shape)
    out = out[slices]
    pad = [(0, t - s) for t, s in zip(target_shape, out.shape)]
    if any(p[1] for p in pad):
        out = np.pad(out, pad, mode="edge")
    return out


def crop_to_mask(image, label, mask, margin):
    idx = np.nonzero(mask)
    if len(idx[0]) == 0:
        return image, label
    lo = [max(int(i.min()) - m, 0) for i, m in zip(idx, margin)]
    hi = [min(int(i.max()) + 1 + m, s)
          for i, m, s in zip(idx, margin, mask.shape)]
    slc = tuple(slice(a, b) for a, b in zip(lo, hi))
    return image[slc], label[slc]


class PreProcessor:
    """Runs the offline pipeline over {train, val, test} splits."""

    def __init__(self, splits, path_to_dataset, path_to_splits,
                 preprocessing_config, data_config):
        self._splits = splits  # {'train': [case dict], ...}
        self._path_to_dataset = Path(path_to_dataset)
        self._path_to_splits = Path(path_to_splits)
        self._cfg = preprocessing_config
        self._data_config = dict(data_config)

        self._shapes = []
        self._bboxes = []
        self._norm_voxels = []

    # -- per-case ---------------------------------------------------------
    def _load_case(self, case):
        img = load_nifti(self._path_to_dataset / case["image"])
        lbl = load_nifti(self._path_to_dataset / case["label"])
        image, _ = reorient_ras(img["data"], img["affine"])
        label, _ = reorient_ras(lbl["data"], lbl["affine"])
        return image.astype(np.float32), np.rint(label).astype(np.int32)

    def _preprocess(self, image, label):
        border = self._cfg.get("border_organs")
        margin = self._cfg.get("margin", [2, 2, 2])
        if border:
            mask = np.isin(label, border)
        else:
            mask = label > 0
        image, label = crop_to_mask(image, label, mask, margin)
        shape = tuple(self._cfg["resize_shape"])
        image = resize_volume(image, shape, order=1)
        label = resize_volume(label, shape, order=0)
        return image, label

    def _passes_filters(self, label, case_name):
        border = self._cfg.get("border_organs")
        if border:
            unique = set(np.unique(label).tolist())
            if not all(b in unique for b in border):
                logger.info("skipped %s: missing border organs", case_name)
                return False
            boundary = np.zeros(label.shape, bool)
            boundary[0, :, :] = boundary[-1, :, :] = True
            boundary[:, 0, :] = boundary[:, -1, :] = True
            boundary[:, :, 0] = boundary[:, :, -1] = True
            if np.isin(label[boundary], border).any():
                logger.info("skipped %s: border organ on volume boundary",
                            case_name)
                return False
        min_organs = self._cfg.get("min_num_organs")
        if min_organs:
            if len(np.unique(label)) - 1 < min_organs:
                logger.info("skipped %s: fewer than %d organs", case_name,
                            min_organs)
                return False
        return True

    # -- all splits ------------------------------------------------------
    def run(self):
        for split_name, cases in self._splits.items():
            logger.info("preparing %s set (%d cases)", split_name, len(cases))
            for case in cases:
                name = case.get("name") or Path(case["image"]).stem.replace(
                    ".nii", "")
                try:
                    image, label = self._load_case(case)
                except (ValueError, FileNotFoundError) as e:
                    logger.warning("skipped %s: %s", name, e)
                    continue
                image, label = self._preprocess(image, label)
                if not self._passes_filters(label, name):
                    continue

                if split_name != "test":
                    self._shapes.append(image.shape)
                    boxes, classes = segmentation2bbox_np(label, padding=1)
                    self._bboxes.append((boxes, classes))
                    fg = image[label > 0]
                    self._norm_voxels.append(fg[::10])

                case_dir = self._path_to_splits / split_name / name
                case_dir.mkdir(parents=True, exist_ok=True)
                np.save(case_dir / "data.npy", image.astype(np.float32))
                np.save(case_dir / "label.npy", label.astype(np.int32))
                logger.info("prepared %s (%s)", name, image.shape)

        if not self._shapes:
            # every case was filtered out — writing statistics would put
            # NaN-cast garbage into data_info.json (empty-slice means +
            # invalid int casts); fail loudly instead
            raise RuntimeError(
                "preprocessing produced zero cases (all filtered); "
                "refusing to write NaN statistics to data_info.json — "
                "check the organ/border filters against this dataset")
        self._data_config["bbox_properties"] = self._bbox_props()
        self._data_config["shape_statistics"] = self._shape_stats()
        self._data_config["foreground_voxel_statistics"] = self._voxel_stats()
        self._data_config["preprocessing_config"] = dict(self._cfg)
        write_json(self._data_config, self._path_to_splits / "data_info.json")

    # -- statistics -------------------------------------------------------
    def _bbox_props(self):
        per_class = defaultdict(list)
        for boxes, classes in self._bboxes:
            for box, cls in zip(boxes, classes):
                per_class[int(cls)].append(box)

        props = {}
        for cls in sorted(per_class):
            arr = np.stack(per_class[cls])
            corners = box_cxcyczwhd_to_xyzxyz(arr)
            props[str(cls)] = {
                "median": np.median(arr, 0).tolist(),
                "mean": arr.mean(0).tolist(),
                "min": arr.min(0).tolist(),
                "max": arr.max(0).tolist(),
                "percentile_99_5": np.percentile(arr, 99.5, 0).tolist(),
                "percentile_00_5": np.percentile(arr, 0.5, 0).tolist(),
                "attn_area": np.concatenate(
                    [corners[:, :3].min(0), corners[:, 3:].max(0)]).tolist(),
            }
        return props

    def _shape_stats(self):
        shapes = np.array(self._shapes)
        return {
            "median": np.median(shapes, 0).astype(int).tolist(),
            "mean": shapes.mean(0).tolist(),
            "min": shapes.min(0).tolist(),
            "max": shapes.max(0).tolist(),
            "percentile_99_5": np.percentile(shapes, 99.5, 0).tolist(),
            "percentile_00_5": np.percentile(shapes, 0.5, 0).tolist(),
        }

    def _voxel_stats(self):
        voxels = (np.concatenate(self._norm_voxels)
                  if self._norm_voxels else np.zeros(1, np.float32))
        return {
            "median": float(np.median(voxels)),
            "mean": float(voxels.mean()),
            "std": float(voxels.std()),
            "min": float(voxels.min()),
            "max": float(voxels.max()),
            "percentile_99_5": float(np.percentile(voxels, 99.5)),
            "percentile_00_5": float(np.percentile(voxels, 0.5)),
        }
