"""Ready-made configs, runs and requests for the port's smoke test, profiler
and dry runs, which have no dataset and no trained weights on disk.

- ``fill_synthetic_stats``, ``flagship_config``, ``tiny_flagship_config``:
  copies of the JAX package's presets (``transoar_tpu/presets.py``; the
  tests pin them): foc_dec_amos at 256x256x128 with synthetic dataset
  statistics, and a structurally faithful tiny variant.
- ``swin_fpn_config``, ``tiny_swin_config``: the same for swin_fpn_visceral
  (SwinFPN + Focused Decoder, 160x160x256, 20 organs), and a tiny variant
  whose Swin stages keep 5x5x5 windows, shifted and clamped.
- ``model_config``: any shipped ``config/<name>.yaml`` as shipped, with
  synthetic dataset statistics (foc_dec_seg_amos, foc_dec_refine_amos,
  detr_amos, def_detr_amos, ...).
- ``retina_unet_config``: retina_amos with the seg proxy (Retina U-Net).
- ``tiny_config(family)``: tiny variants of the seg-proxy, refine, DETR,
  Deformable-DETR and RetinaNet families, built on ``tiny_flagship_config``
  with the family's keys set as its shipped config sets them.
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


def model_config(name, batch_size=None, patch_size=None):
    """``config/<name>.yaml`` with synthetic dataset statistics."""
    cfg = fill_synthetic_stats(get_config(name))
    if batch_size is not None:
        cfg["trainer"]["batch_size"] = batch_size
    if patch_size is not None:
        cfg["augmentation"]["patch_size"] = list(patch_size)
    return cfg


def flagship_config(batch_size=None, patch_size=None):
    """Focused Decoder + AttnFPN on AMOS-shaped volumes (foc_dec_amos)."""
    return model_config("foc_dec_amos", batch_size, patch_size)


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


def swin_fpn_config(batch_size=None, patch_size=None):
    """SwinFPN + Focused Decoder on VISCERAL-shaped volumes
    (swin_fpn_visceral)."""
    return model_config("swin_fpn_visceral", batch_size, patch_size)


def tiny_swin_config(num_organs=6, patch=(40, 40, 16)):
    """Tiny swin_fpn_visceral for the CPU and the card's small checks: 4
    stages (CNN 8 -> 16 channels, Swin 16 -> 32 -> 64), 2 blocks per Swin
    stage with 2 heads (d = 8, then 16) and 5x5x5 windows. At 40x40x16
    stage 2 pads 20x20x8 to 32 windows per volume, shifted in its second
    block; stage 3's depth of 4 clamps the window to 5x5x4 and drops that
    axis's shift."""
    cfg = swin_fpn_config(batch_size=2, patch_size=patch)
    cfg["neck"]["num_organs"] = num_organs
    cfg["neck"]["num_queries"] = num_organs * 27
    cfg["neck"]["hidden_dim"] = 96
    cfg["neck"]["dim_feedforward"] = 128
    cfg["neck"]["input_levels"] = "P2"
    backbone = cfg["backbone"]
    backbone["start_channels"] = 8
    backbone["num_stages"] = 4
    backbone["strides"] = [[1, 1, 1]] + [[2, 2, 2]] * 3
    backbone["fpn_channels"] = 96
    backbone["out_fmaps"] = ["P2"]
    backbone["swin"].update(depths=[2, 2], num_heads=[2, 2])
    del cfg["bbox_properties"]
    del cfg["labels"]
    return fill_synthetic_stats(cfg)


def retina_unet_config(batch_size=None, patch_size=None):
    """Retina U-Net: retina_amos with ``backbone.use_seg_proxy_loss: true``,
    as the yaml's header says (the decoder down to P0 and the 1x1x1 seg
    head beside the towers)."""
    cfg = model_config("retina_amos", batch_size, patch_size)
    cfg["experiment_name"] = "retina_unet_amos"
    cfg["backbone"]["use_seg_proxy_loss"] = True
    return cfg


# the shipped config each tiny family takes its keys from
FAMILIES = {"seg": "foc_dec_seg_amos", "refine": "foc_dec_refine_amos",
            "detr": "detr_amos", "def_detr": "def_detr_amos",
            "retina": "retina_amos", "retina_unet": "retina_amos"}

# the tiny RetinaNet's section: tests/test_retina.py's sizes, with K = 4
# anchors a voxel (2 scales x 2 ratios) so that the anchor order counts
TINY_RETINA = {"levels": ["P2", "P3"], "anchor_scales": [8, 12],
               "anchor_ratios": [[1, 1, 1], [1.5, 1, 0.8]],
               "tower_depth": 1, "tower_channels": 8, "pos_iou": 0.4,
               "neg_iou": 0.3, "focal_alpha": 0.25, "focal_gamma": 2.0,
               "nms_iou": 0.5, "score_threshold": 0.05}


def tiny_config(family, num_organs=6, patch=(32, 32, 16)):
    """``tiny_flagship_config`` (4 CNN stages 8 -> 64 channels, FPN and
    neck at 96) turned into ``family`` as its shipped config does it:

    - ``seg``: the seg proxy (out0 and the seg head on P0, 32x32x16);
    - ``refine``: the deformable refine over P2-P3 (8x8x4 + 4x4x2 tokens),
      6 heads x 16, 2 points, 2 layers;
    - ``detr``: the DETR neck, 20 queries, 8 heads, 3 layers, dense
      cross-attention over P2, the Hungarian set criterion;
    - ``def_detr``: Deformable DETR over P2-P3, 6 heads, 2 points;
    - ``retina``: RetinaNet over P2-P3 (``TINY_RETINA``: 4 anchors a voxel,
      1,024 + 128 at 32x32x16, one tower conv of 8 channels before
      ``out``);
    - ``retina_unet``: the same with the seg proxy.
    """
    cfg = tiny_flagship_config(num_organs, patch)
    shipped = get_config(FAMILIES[family])
    backbone, neck = cfg["backbone"], cfg["neck"]
    for key in ("use_seg_proxy_loss", "fg_bg", "use_decoder_attn"):
        backbone[key] = shipped["backbone"][key]
    if family == "refine":
        backbone["def_attn"].update(feature_levels=["P2", "P3"],
                                    hidden_dim=96, dim_feedforward=128,
                                    n_points=2)
    if family in ("detr", "def_detr"):
        cfg["matching"] = dict(shipped["matching"])
        for key in ("name", "dec_layers", "restrict_attn",
                    "anchor_gen_dynamic_offset", "anchor_offset_pred",
                    "aux_loss", "nheads"):
            neck[key] = shipped["neck"][key]
        neck.update(num_queries=20, dec_layers=3)
    if family == "def_detr":
        neck.update(feature_levels=["P2", "P3"], n_points=2)
        backbone["out_fmaps"] = ["P2", "P3"]
    if family in ("retina", "retina_unet"):
        cfg["retina"] = copy.deepcopy(TINY_RETINA)
        backbone["out_fmaps"] = ["P2", "P3"]
        backbone["use_seg_proxy_loss"] = family == "retina_unet"
        cfg["experiment_name"] = f"tiny_{family}"
    return cfg


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
