"""Intensity transforms of the evaluation path (port of the val/test part of
``transoar_tpu/data/transforms.py``). The training augmentations come with
the training slice."""

from __future__ import annotations

import torch


def scale_intensity_range(image: torch.Tensor, a_min, a_max, b_min=0.0,
                          b_max=1.0) -> torch.Tensor:
    """Window + rescale + clip (MONAI ScaleIntensityRanged semantics)."""
    scaled = (image - a_min) / (a_max - a_min) * (b_max - b_min) + b_min
    return scaled.clamp(b_min, b_max)


def eval_transform(images: torch.Tensor, intensity_stats) -> torch.Tensor:
    """Val/test path: intensity window only (reference
    transforms.py:168-205)."""
    return scale_intensity_range(images, intensity_stats["percentile_00_5"],
                                 intensity_stats["percentile_99_5"])
