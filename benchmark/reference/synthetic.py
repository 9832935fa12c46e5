"""Inputs made from a run's seed: training batches and CT volumes.

- ``train_batches``: ``transoar_tpu_torch/bench.py::synthetic_batch``'s
  arithmetic (frozen at commit bf64563: an N(0, 1) image and one cuboid
  per organ at its ``bbox_properties`` median, at least 8 voxels a side),
  made on the device, with each row's cuboids jittered from the seed
  (centres by up to 5% of the patch, sides by up to 20%) so that every
  row differs. Images bf16 and labels int8, as the trainer copies them.
- ``ct_volume``: ``transoar_tpu_torch/presets.py::write_ct_volumes``'s
  volume (frozen at bf64563): an ellipsoid body at 40 HU in -1000 HU air
  plus N(0, 30) noise, int16, made on the device.
- ``sub_seed``: independent seeds of one run's parts.
"""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, part: str) -> int:
    """A 63-bit seed of ``part`` of the run seeded ``seed``."""
    words = [int(seed) % 2 ** 63] + [ord(c) for c in part]
    return int(np.random.SeedSequence(words).generate_state(
        2, np.uint32).astype(np.uint64) @ np.array([2 ** 31, 1], np.uint64))


def _cuboids(config, rng, patch):
    """(class, lo, hi) of each organ's jittered median box, in voxels."""
    patch = np.asarray(patch)
    out = []
    for cls, props in config["bbox_properties"].items():
        median = np.asarray(props["median"], np.float64)
        c = (median[:3] + rng.uniform(-0.05, 0.05, 3)) * patch
        s = np.maximum(median[3:] * rng.uniform(0.8, 1.2, 3) * patch, 8)
        lo = np.maximum((c - s / 2).astype(int), 0)
        hi = np.minimum((c + s / 2).astype(int), patch)
        out.append((int(cls), lo, hi))
    return out


def train_batches(config, count, seed, device):
    """``count`` batches {"image": bf16 [B, *patch, 1], "seg": int8
    [B, *patch]} of the config's batch size and patch."""
    B = int(config["trainer"]["batch_size"])
    patch = tuple(config["augmentation"]["patch_size"])
    gen = torch.Generator(device=device).manual_seed(seed)
    images = torch.randn((count, B, *patch, 1), generator=gen,
                         device=device).to(torch.bfloat16)
    segs = torch.zeros((count, B, *patch), dtype=torch.int8, device=device)
    rng = np.random.default_rng(seed)
    for k in range(count):
        for b in range(B):
            for cls, lo, hi in _cuboids(config, rng, patch):
                segs[k, b, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = cls
    return [{"image": images[k], "seg": segs[k]} for k in range(count)]


def ct_volume(shape, seed, device):
    """int16 [X, Y, Z] CT-like volume on the host."""
    gen = torch.Generator(device=device).manual_seed(seed)
    axes = [torch.linspace(-1, 1, s, device=device) for s in shape]
    r2 = (axes[0][:, None, None] ** 2 + axes[1][None, :, None] ** 2
          + axes[2][None, None, :] ** 2)
    vol = torch.where(r2 < 0.8, 40.0, -1000.0) + 30.0 * torch.randn(
        shape, generator=gen, device=device)
    return vol.to(torch.int16).cpu().numpy()


def ct_case(config, patch, seed, device):
    """A preprocessed training case (image f32 HU [*patch], labels int32):
    the ``ct_volume`` body with one cuboid per organ at its jittered median
    box, each organ at its own intensity (40 + 5 * class HU)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    axes = [torch.linspace(-1, 1, s, device=device) for s in patch]
    r2 = (axes[0][:, None, None] ** 2 + axes[1][None, :, None] ** 2
          + axes[2][None, None, :] ** 2)
    image = torch.where(r2 < 0.8, 40.0, -1000.0)
    label = torch.zeros(patch, dtype=torch.int32, device=device)
    rng = np.random.default_rng(seed)
    for cls, lo, hi in _cuboids(config, rng, patch):
        label[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = cls
        image[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 40.0 + 5.0 * cls
    image = image + 30.0 * torch.randn(patch, generator=gen, device=device)
    return image.cpu().numpy(), label.cpu().numpy()
