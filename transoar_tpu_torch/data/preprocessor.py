"""Host-side volume resize (copy of ``resize_volume`` from
``transoar_tpu/data/preprocessor.py``, whose module imports jax through
``utils/boxes.py``)."""

from __future__ import annotations

import numpy as np
from scipy import ndimage


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
