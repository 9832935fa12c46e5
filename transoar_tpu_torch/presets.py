"""Ready-made configs, runs and requests for the port's smoke test, profiler
and dry runs, which have no dataset and no trained weights on disk.

- ``flagship_config`` / ``tiny_flagship_config``: the JAX package's presets
  (``transoar_tpu/presets.py`` imports no jax, so it is imported here rather
  than copied): foc_dec_amos at 256x256x128 with synthetic dataset
  statistics, and a structurally faithful tiny variant.
- ``save_random_run``: a run directory (``training/checkpoints.py`` layout)
  whose every parameter is drawn from a seed, for ``predict`` to restore.
- ``write_ct_volumes``: CT-like int16 NIfTI volumes with LPS-style affines,
  so that serving's reorientation and resize both run.

``chip_smoke.py`` and ``scripts/profile_torch_serving.py`` take all of these
from here, so that they import the port and nothing of the JAX package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from transoar_tpu.data.nifti import write_nifti
from transoar_tpu.presets import flagship_config, tiny_flagship_config
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.training import checkpoints as ckpt_lib
from transoar_tpu_torch.utils.weights import random_state_dict

__all__ = ["flagship_config", "tiny_flagship_config", "save_random_run",
           "write_ct_volumes"]


def save_random_run(config, path_to_run, seed=0, name="model_last") -> Path:
    """Freeze ``config`` and save a checkpoint of seeded random weights
    (``utils.weights.random_state_dict``: no zero heads) into
    ``path_to_run``; returns the checkpoint's path."""
    model = build_model(config, device="cpu")
    model.load_state_dict(random_state_dict(model, seed))
    ckpt_lib.freeze_run_config(config, path_to_run)
    return ckpt_lib.save_checkpoint(path_to_run, name, model)


def write_ct_volumes(dirname, shapes, seed=0) -> list[str]:
    """One ``case<i>.nii.gz`` per shape: an ellipsoid body at 40 HU in -1000
    HU air plus N(0, 30) noise, int16, with a flipped-axes (LPS) affine.
    Returns the paths."""
    rng = np.random.default_rng(seed)
    paths = []
    for i, shape in enumerate(shapes):
        grid = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape],
                           indexing="ij", sparse=True)
        body = sum(g ** 2 for g in grid) < 0.8
        vol = np.where(body, 40.0, -1000.0) + rng.normal(0, 30, size=shape)
        affine = np.diag([-0.8, -0.8, 2.5, 1.0])
        affine[:3, 3] = (120.0, 110.0, -150.0 + 10 * i)
        path = Path(dirname) / f"case{i}.nii.gz"
        write_nifti(vol.astype(np.int16), path, affine=affine)
        paths.append(str(path))
    return paths
