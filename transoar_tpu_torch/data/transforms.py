"""Intensity window and training augmentation (port of
``transoar_tpu/data/transforms.py``).

Two augmentation paths, chosen by ``augmentation.on_device``:

- **Host** (``on_device: false``, every shipped config): ``augment_case_np``
  (numpy + scipy, a copy of the JAX package's, pinned bit for bit by
  ``tests/test_torch_copies.py``) run per case in a thread pool by
  ``HostAugmentingLoader`` (how far the threads scale on a host is
  measured by ``chip_smoke.py``). Each case's draws come from its own
  seed ``seed*1_000_003 + epoch*10_007 + step*101 + case``.
- **Device** (``on_device: true``): ``augment_batch`` on the tensors' own
  device with draws from an explicit ``torch.Generator`` on that device,
  with no host round trip. One composed affine per case (rotation, zoom,
  shear, translation, flips about the volume's centre) applied as one
  gather: trilinear with zero padding for the image, nearest
  (round half to even) for the labels; then noise, gaussian smoothing,
  scale, shift and contrast, each applied with its probability. The
  intensity window goes before the resample. The JAX package's default
  ``resample: separable`` (banded-matmul passes for the TPU's MXU) is not
  ported: both ``resample`` values compute the gather here.

The draws of the device path come from torch's generator, not
``jax.random``, so only the operations on fixed parameters and the
ranges of the draws compare with the JAX package.
"""

from __future__ import annotations

import collections
import math
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
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


# ---------------------------------------------------------------------------
# Device path
# ---------------------------------------------------------------------------

def _rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Rotation about the three axes, composed R2 @ R1 @ R0."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[0]), torch.zeros_like(c[0])
    r0 = torch.stack([one, zero, zero, zero, c[0], -s[0],
                      zero, s[0], c[0]]).view(3, 3)
    r1 = torch.stack([c[1], zero, s[1], zero, one, zero,
                      -s[1], zero, c[1]]).view(3, 3)
    r2 = torch.stack([c[2], -s[2], zero, s[2], c[2], zero,
                      zero, zero, one]).view(3, 3)
    return r2 @ r1 @ r0


def _between(u, lo, hi):
    """Map U(0, 1) draws onto U(lo, hi)."""
    return lo + (hi - lo) * u


def _vec(values, device):
    """A small f32 vector made on ``device`` by fill kernels: no copy from
    the host, so the device path never waits on one."""
    return torch.stack([torch.full((), float(v), device=device)
                        for v in values])


def sample_affine(generator: torch.Generator, spatial_shape, aug):
    """Draw one composed affine (output voxel -> source voxel), centre-
    anchored, on the generator's device: ``(matrix [3, 3], offset [3])``
    f32 with ``source = matrix @ out + offset``."""
    device = generator.device
    u = torch.rand(19, generator=generator, device=device)
    center = _vec([(s - 1.0) / 2.0 for s in spatial_shape], device)

    deg = [float(d) / 180 * math.pi for d in aug.get("rotation", [0, 0])]
    angles = torch.where(u[0] < aug.get("p_rotate", 0.0),
                         _between(u[1:4], deg[0], deg[1]), 0.0)
    zoom = torch.where(u[4] < aug.get("p_zoom", 0.0),
                       _between(u[5:8], aug.get("min_zoom", 1.0),
                                aug.get("max_zoom", 1.0)), 1.0)
    sh = _vec(aug.get("shear_range", [0, 0, 0]), device)
    shear_vals = torch.where(u[8] < aug.get("p_shear", 0.0),
                             _between(u[9:12], -sh, sh), 0.0)
    t = _vec([s * aug.get("translate_percentage", 0) / 100.0
              for s in spatial_shape], device)
    trans = torch.where(u[12] < aug.get("p_translate", 0.0),
                        _between(u[13:16], -t, t), 0.0)
    flip = 1.0 - 2.0 * (u[16:19] < aug.get("p_flip", 0.0)).float()

    one, zero = torch.ones_like(u[0]), torch.zeros_like(u[0])
    shear = torch.stack([one, shear_vals[0], shear_vals[1],
                         zero, one, shear_vals[2],
                         zero, zero, one]).view(3, 3)
    # output zoomed by z means source coords scaled by 1/z
    matrix = _rotation_matrix(angles) @ shear @ torch.diag(1.0 / zoom) \
        @ torch.diag(flip)
    offset = center - matrix @ center - trans
    return matrix, offset


def affine_resample(volume: torch.Tensor, matrix: torch.Tensor,
                    offset: torch.Tensor, order: int) -> torch.Tensor:
    """Resample ``volume`` [S0, S1, S2] by ``source = matrix @ out +
    offset`` with zero padding: order 1 trilinear (image), order 0 nearest
    with ties rounded to even as ``jnp.round`` (labels). One gather, the
    JAX package's ``affine_resample``."""
    shape = volume.shape
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.float32,
                                          device=volume.device)
                             for s in shape], indexing="ij")
    out_coords = torch.stack([g.reshape(-1) for g in grids])  # [3, N]
    src = matrix.float() @ out_coords + offset.float()[:, None]
    flat_vol = volume.reshape(-1)

    def gather(idx):
        """Values at the integer source positions ``idx`` (3 rows), 0
        outside the volume."""
        valid = (idx[0] >= 0) & (idx[0] < shape[0])
        for a in (1, 2):
            valid &= (idx[a] >= 0) & (idx[a] < shape[a])
        i0, i1, i2 = (idx[a].clamp(0, shape[a] - 1) for a in range(3))
        return torch.where(valid, flat_vol[(i0 * shape[1] + i1) * shape[2]
                                           + i2], 0)

    if order == 0:
        out = gather(torch.round(src).long())
    else:
        floor = torch.floor(src)
        frac = src - floor
        floor = floor.long()
        out = 0.0
        for corner in range(8):
            bits = [(corner >> a) & 1 for a in range(3)]
            w = [frac[a] if bits[a] else 1 - frac[a] for a in range(3)]
            out = out + w[0] * w[1] * w[2] * gather(
                [floor[a] + bits[a] for a in range(3)])
    return out.reshape(shape).to(volume.dtype)


def gaussian_smooth(image: torch.Tensor, sigmas: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """Separable gaussian blur over the first three axes with zero padding
    (MONAI ``GaussianSmooth``, reference transforms.py:144-149);
    ``radius`` is the kernel's half-width."""
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32,
                        device=image.device)
    for axis in range(3):
        w = torch.exp(-0.5 * (offs / sigmas[axis].clamp(min=1e-6)) ** 2)
        w = w / w.sum()
        pad = [0, 0] * (image.dim() - 1 - axis) + [radius, radius]
        padded = torch.nn.functional.pad(image, pad)
        out = torch.zeros_like(image)
        for k in range(2 * radius + 1):
            out = out + w[k] * padded.narrow(axis, k, image.shape[axis])
        image = out
    return image


def intensity_augment(generator: torch.Generator, image: torch.Tensor,
                      aug) -> torch.Tensor:
    """Noise, gaussian smoothing (radius ``round(4 * sigma_max)``), scale
    ``v * (1 + f)``, shift ``v + o`` and contrast gamma, each applied with
    its probability (reference transforms.py:140-161). An operation whose
    probability is 0 in the config is not computed: the check reads only
    the config, so it costs no host sync."""
    u = torch.rand(11, generator=generator, device=image.device)

    p_noise = aug.get("p_gaussian_noise", 0.0)
    if p_noise > 0.0:
        noise = torch.randn(image.shape, generator=generator,
                            device=image.device) \
            * aug.get("gaussian_noise_std", 0.1) \
            + aug.get("gaussian_noise_mean", 0)
        image = torch.where(u[0] < p_noise, image + noise, image)

    p_smooth = aug.get("p_gaussian_smooth", 0.0)
    if p_smooth > 0.0:
        sig = aug.get("gaussian_smooth_sigma", (0.5, 1.0))
        sigmas = _between(u[2:5], sig[0], sig[1])
        radius = max(1, int(round(4 * float(sig[1]))))
        image = torch.where(u[1] < p_smooth,
                            gaussian_smooth(image, sigmas, radius), image)

    p_scale = aug.get("p_intensity_scale", 0.0)
    if p_scale > 0.0:
        f = aug.get("intensity_scale_factors", 0.1)
        image = torch.where(u[5] < p_scale,
                            image * (1.0 + _between(u[6], -f, f)), image)

    p_shift = aug.get("p_intensity_shift", 0.0)
    if p_shift > 0.0:
        o = aug.get("intensity_shift_offsets", 0.1)
        image = torch.where(u[7] < p_shift,
                            image + _between(u[8], -o, o), image)

    p_contrast = aug.get("p_adjust_contrast", 0.0)
    if p_contrast > 0.0:
        g = aug.get("adjust_contrast_gamma", [1.0, 1.0])
        gamma = _between(u[10], g[0], g[1])
        lo, hi = image.min(), image.max()
        normed = (image - lo) / (hi - lo + 1e-7)
        image = torch.where(u[9] < p_contrast,
                            normed ** gamma * (hi - lo) + lo, image)
    return image


def augment_batch(images: torch.Tensor, labels: torch.Tensor,
                  generator: torch.Generator, aug_config,
                  intensity_stats=None):
    """Augment a batch on its device: images [B, S0, S1, S2, 1] f32,
    labels [B, S0, S1, S2] int. ``intensity_stats`` (the foreground
    percentiles) windows the images first, as the reference pipeline
    does."""
    if intensity_stats is not None:
        images = eval_transform(images, intensity_stats)
    out_img, out_lab = [], []
    for image, label in zip(images, labels):
        matrix, offset = sample_affine(generator, image.shape[:3],
                                       aug_config)
        img = affine_resample(image[..., 0], matrix, offset, order=1)
        out_lab.append(affine_resample(label, matrix, offset, order=0))
        out_img.append(intensity_augment(generator, img[..., None],
                                         aug_config))
    return torch.stack(out_img), torch.stack(out_lab)


# ---------------------------------------------------------------------------
# Host path: copies of the JAX package's numpy/scipy functions
# ---------------------------------------------------------------------------

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


class HostAugmentingLoader:
    """Wraps a loader and augments each case of its batches in a pool of
    ``workers`` threads.

    ``ahead`` = how many cases the pool may work on beyond the batch being
    handed out. 0 is the JAX package's design: one batch's rows at a time,
    so at batch 2 only two threads work. With ``ahead > 0`` the loader
    pulls later batches early and keeps up to ``ahead`` of their cases in
    flight while the caller holds the current one. Each case's seed is
    ``seed*1_000_003 + epoch*10_007 + step*101 + case`` (``case`` = the
    dataset index the batch carries), so the batches are the same bits
    whatever ``ahead`` and ``workers`` are.

    ``case_ms`` collects each augmented case's host time in ms.
    """

    def __init__(self, loader, aug_config, intensity_stats=None, seed=0,
                 workers=8, ahead=0):
        self._loader = loader
        self._aug = dict(aug_config)
        self._stats = intensity_stats
        self._seed = seed
        self._epoch = 0
        self._workers = workers
        self._ahead = ahead
        self.case_ms = []

    def __len__(self):
        return len(self._loader)

    def _one(self, epoch, step, batch, i):
        # seeded by the case's identity (the dataset index the batch
        # carries), not its row, as the JAX package's loader
        case = int(batch["index"][i])
        seed = self._seed * 1_000_003 + epoch * 10_007 + step * 101 + case
        t0 = time.perf_counter()
        out = augment_case_np(batch["image"][i], batch["seg"][i], seed,
                              self._aug, self._stats)
        self.case_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    def __iter__(self):
        epoch = self._epoch
        self._epoch += 1
        pending = collections.deque()  # (batch, its futures), in step order

        def beyond_head():
            return sum(len(futures) for _, futures in pending) - len(
                pending[0][1])

        with ThreadPoolExecutor(max_workers=self._workers) as pool:
            batches = enumerate(self._loader)
            try:
                while True:
                    while not pending or beyond_head() < self._ahead:
                        step, batch = next(batches, (None, None))
                        if batch is None:
                            break
                        pending.append((batch, [
                            pool.submit(self._one, epoch, step, batch, i)
                            for i in range(len(batch["index"]))]))
                    if not pending:
                        return
                    batch, futures = pending.popleft()
                    results = [f.result() for f in futures]
                    yield dict(batch,
                               image=np.stack([r[0] for r in results]),
                               seg=np.stack([r[1] for r in results]))
            finally:
                for _, futures in pending:
                    for f in futures:
                        f.cancel()
