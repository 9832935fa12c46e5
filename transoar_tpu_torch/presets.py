"""Ready-made configs, runs and requests for the port's smoke test, profiler
and dry runs, which have no dataset and no trained weights on disk.

- ``fill_synthetic_stats``, ``flagship_config``, ``tiny_flagship_config``:
  copies of the JAX package's presets (``transoar_tpu/presets.py``; the
  tests pin them): foc_dec_amos at 256x256x128 with synthetic dataset
  statistics, and a structurally faithful tiny variant.
- ``save_random_run``: a run directory (``training/checkpoints.py`` layout)
  whose every parameter is drawn from a seed, for ``predict`` to restore.
- ``write_ct_volumes``: CT-like int16 NIfTI volumes with LPS-style affines,
  so that serving's reorientation and resize both run.

``chip_smoke.py`` and ``scripts/profile_torch_serving.py`` take all of these
from here.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np

from transoar_tpu_torch.data.nifti import write_nifti
from transoar_tpu_torch.models.anchors import synthetic_bbox_props
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.training import checkpoints as ckpt_lib
from transoar_tpu_torch.utils.io import PATH_TO_CONFIG, get_config, load_yaml
from transoar_tpu_torch.utils.weights import random_state_dict


def fill_synthetic_stats(config, seed=None):
    """Fill missing ``bbox_properties`` (synthetic priors) and labels (the
    dataset config's, else ``organ<i>``) of ``config``; returns a copy."""
    config = copy.deepcopy(config)
    num_organs = config["neck"]["num_organs"]
    if "bbox_properties" not in config:
        config["bbox_properties"] = synthetic_bbox_props(
            num_organs, seed=seed if seed is not None else config["seed"])
    if "labels" not in config:
        ds_cfg_name = config.get("dataset_config")
        labels = None
        if ds_cfg_name:
            try:
                ds_cfg = load_yaml(PATH_TO_CONFIG / f"{ds_cfg_name}.yaml")
                labels = {str(k): v for k, v in ds_cfg["labels"].items()}
                for key in ("labels_small", "labels_mid", "labels_large"):
                    config[key] = {str(k): v for k, v in ds_cfg[key].items()}
            except FileNotFoundError:
                labels = None
        if labels is None:
            labels = {str(i + 1): f"organ{i + 1}" for i in range(num_organs)}
            config["labels_small"] = {"1": labels["1"]}
            config["labels_mid"] = {
                str(i + 1): labels[str(i + 1)]
                for i in range(1, max(num_organs - 1, 1))}
            config["labels_large"] = {str(num_organs): labels[str(num_organs)]}
        config["labels"] = labels
    return config


def flagship_config(batch_size=None, patch_size=None):
    """Focused Decoder + AttnFPN on AMOS-shaped volumes (foc_dec_amos)."""
    cfg = fill_synthetic_stats(get_config("foc_dec_amos"))
    if batch_size is not None:
        cfg["trainer"]["batch_size"] = batch_size
    if patch_size is not None:
        cfg["augmentation"]["patch_size"] = list(patch_size)
    return cfg


def tiny_flagship_config(num_organs=6, patch=(32, 32, 16)):
    """Structurally faithful tiny variant for dry runs on the CPU."""
    cfg = flagship_config(batch_size=8, patch_size=patch)
    cfg["neck"]["num_organs"] = num_organs
    cfg["neck"]["num_queries"] = num_organs * 27
    cfg["neck"]["hidden_dim"] = 96
    cfg["neck"]["dim_feedforward"] = 128
    cfg["backbone"]["start_channels"] = 8
    cfg["backbone"]["num_stages"] = 4
    cfg["backbone"]["strides"] = [[1, 1, 1]] + [[2, 2, 2]] * 3
    cfg["backbone"]["fpn_channels"] = 96
    cfg["backbone"]["out_fmaps"] = ["P2"]
    cfg["neck"]["input_levels"] = "P2"
    del cfg["bbox_properties"]
    del cfg["labels"]
    return fill_synthetic_stats(cfg)


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
