"""The host half of the training loop's input, worked out again: the
native loader's epoch order, the host augmentation's per-case seed, and the
augmentation itself.

``sample_affine_np`` and ``augment_case_np`` are frozen copies of
``transoar_tpu_torch/data/transforms.py`` at commit bf64563 (numpy and
scipy, the same draws bit for bit); ``epoch_order`` follows
``native/native_loader.NativeLoader.__iter__`` (a shuffle seeded per
epoch), ``case_seed`` ``HostAugmentingLoader._one``.
"""

from __future__ import annotations

import numpy as np


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The case indices of the loader's ``epoch``, shuffled from
    ``seed + epoch``."""
    order = np.arange(n, dtype=np.int64)
    np.random.default_rng(seed + epoch).shuffle(order)
    return order


def case_seed(seed: int, epoch: int, step: int, case: int) -> int:
    """The host augmentation's seed of ``case`` in batch ``step`` of the
    augmenting loader's ``epoch``."""
    return seed * 1_000_003 + epoch * 10_007 + step * 101 + case


def sample_affine_np(rng, spatial_shape, aug):
    """Numpy twin of ``sample_affine`` (output voxel -> source voxel)."""
    shape = np.asarray(spatial_shape, np.float64)
    center = (shape - 1.0) / 2.0

    deg = np.asarray(aug.get("rotation", [0, 0]), np.float64) / 180 * np.pi
    angles = (rng.uniform(deg[0], deg[1], 3)
              if rng.uniform() < aug.get("p_rotate", 0.0) else np.zeros(3))
    cx, sx = np.cos(angles[0]), np.sin(angles[0])
    cy, sy = np.cos(angles[1]), np.sin(angles[1])
    cz, sz = np.cos(angles[2]), np.sin(angles[2])
    r0 = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    r1 = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    r2 = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    rot = r2 @ r1 @ r0

    zoom = (rng.uniform(aug.get("min_zoom", 1.0), aug.get("max_zoom", 1.0), 3)
            if rng.uniform() < aug.get("p_zoom", 0.0) else np.ones(3))
    scale = np.diag(1.0 / zoom)

    sh = np.asarray(aug.get("shear_range", [0, 0, 0]), np.float64)
    shear_vals = (rng.uniform(-sh, sh)
                  if rng.uniform() < aug.get("p_shear", 0.0) else np.zeros(3))
    shear = np.array([[1.0, shear_vals[0], shear_vals[1]],
                      [0.0, 1.0, shear_vals[2]],
                      [0.0, 0.0, 1.0]])

    t = shape * aug.get("translate_percentage", 0) / 100.0
    trans = (rng.uniform(-t, t)
             if rng.uniform() < aug.get("p_translate", 0.0) else np.zeros(3))

    flips = (rng.uniform(size=3) < aug.get("p_flip", 0.0)).astype(np.float64)
    flip = np.diag(1.0 - 2.0 * flips)

    matrix = rot @ shear @ scale @ flip
    offset = center - matrix @ center - trans
    return matrix, offset


def augment_case_np(image, label, seed, aug, intensity_stats=None):
    """Augment one case on host. image [S0,S1,S2,1] f32, label [S0,S1,S2]."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    img = image[..., 0].astype(np.float32)

    if intensity_stats is not None:
        lo = intensity_stats["percentile_00_5"]
        hi = intensity_stats["percentile_99_5"]
        img = np.clip((img - lo) / (hi - lo), 0.0, 1.0).astype(np.float32)

    matrix, offset = sample_affine_np(rng, img.shape, aug)
    if not (np.allclose(matrix, np.eye(3)) and np.allclose(offset, 0)):
        img = ndimage.affine_transform(img, matrix, offset, order=1,
                                       mode="constant", cval=0.0)
        label = ndimage.affine_transform(label, matrix, offset, order=0,
                                         mode="constant", cval=0)

    # intensity transforms (same draws as the device path, per-case rng)
    if rng.uniform() < aug.get("p_gaussian_noise", 0.0):
        img = img + rng.normal(aug.get("gaussian_noise_mean", 0.0),
                               aug.get("gaussian_noise_std", 0.1),
                               img.shape).astype(np.float32)
    if rng.uniform() < aug.get("p_gaussian_smooth", 0.0):
        sig = aug.get("gaussian_smooth_sigma", (0.5, 1.0))
        sigmas = rng.uniform(sig[0], sig[1], 3)
        # zero padding to match the device path / MONAI's conv convention
        img = ndimage.gaussian_filter(img, sigma=sigmas, mode="constant",
                                      cval=0.0, truncate=4.0)
    if rng.uniform() < aug.get("p_intensity_scale", 0.0):
        f = aug.get("intensity_scale_factors", 0.1)
        img = img * (1.0 + rng.uniform(-f, f))
    if rng.uniform() < aug.get("p_intensity_shift", 0.0):
        o = aug.get("intensity_shift_offsets", 0.1)
        img = img + rng.uniform(-o, o)
    if rng.uniform() < aug.get("p_adjust_contrast", 0.0):
        g = aug.get("adjust_contrast_gamma", [1.0, 1.0])
        gamma = rng.uniform(g[0], g[1])
        lo, hi = img.min(), img.max()
        img = ((img - lo) / (hi - lo + 1e-7)) ** gamma * (hi - lo) + lo

    return img.astype(np.float32)[..., None], label.astype(np.int32)
