"""Config loading, json/yaml and logging (copy of the parts of
``transoar_tpu/utils/io.py`` that the port calls; the tests pin each
function to its original).

``PATH_TO_CONFIG`` is the repository's ``config/``, which both packages
read.
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path

import yaml

PATH_TO_CONFIG = Path(__file__).resolve().parents[2] / "config"


def load_yaml(path):
    with open(path) as stream:
        return yaml.safe_load(stream)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def write_json(data, path):
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


def get_config(config_name, config_dir=None, dataset_dir=None):
    """Load ``<config_dir>/<config_name>.yaml`` (or a ``.yaml`` path) and
    merge the preprocessed dataset's ``data_info.json`` when the config
    names a ``dataset`` that exists under ``dataset_dir`` (default
    ``./dataset``): anchors and attention masks are functions of it."""
    name = str(config_name)
    if name.endswith((".yaml", ".yml")):
        config = load_yaml(Path(name))
    else:
        config_dir = Path(config_dir) if config_dir else PATH_TO_CONFIG
        config = load_yaml(config_dir / f"{name}.yaml")

    dataset = config.get("dataset")
    if dataset:
        root = Path(dataset_dir) if dataset_dir else Path.cwd() / "dataset"
        data_info = root / dataset / "data_info.json"
        if data_info.exists():
            config.update(load_json(data_info))
    return config


_KNOWN_AUG = {
    "use_augmentation", "on_device", "patch_size",
    "p_gaussian_noise", "gaussian_noise_mean", "gaussian_noise_std",
    "p_gaussian_smooth", "gaussian_smooth_sigma",
    "p_intensity_scale", "intensity_scale_factors",
    "p_intensity_shift", "intensity_shift_offsets",
    "p_adjust_contrast", "adjust_contrast_gamma",
    "p_rotate", "rotation", "p_zoom", "min_zoom", "max_zoom",
    "p_shear", "shear_range", "p_translate", "translate_percentage",
    "p_flip", "flip_axis", "resample",
}


def validate_config(config):
    """Fail fast on missing sections, a query layout the focused decoder
    cannot take, and augmentation keys nothing consumes."""
    required = ["neck", "backbone", "loss_coefs"]
    missing = [k for k in required if k not in config]
    if missing:
        raise KeyError(f"config missing required sections: {missing}")
    neck = config["neck"]
    if neck.get("name", "foc_attn") == "foc_attn" and "retina" not in config:
        qpo, rem = divmod(neck["num_queries"], neck["num_organs"])
        if rem:
            raise ValueError(
                f"num_queries ({neck['num_queries']}) must be a multiple of "
                f"num_organs ({neck['num_organs']})")
        if qpo not in (1, 7, 27, 54):
            raise ValueError(
                f"queries per organ must be in (1, 7, 27, 54), got {qpo}")
    unknown = set(config.get("augmentation", {})) - _KNOWN_AUG
    if unknown:
        raise ValueError(
            f"unknown augmentation config keys (nothing consumes them): "
            f"{sorted(unknown)}")
    return config


def set_root_logger(path=None):
    handlers = [logging.StreamHandler(sys.stdout)]
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        handlers.insert(0, logging.FileHandler(path, "w"))
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s : %(levelname)s [%(module)s, %(lineno)d] "
               "%(message)s",
        handlers=handlers,
        force=True,
    )
