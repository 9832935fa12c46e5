"""Run directories and checkpoints of the port.

Same layout as the JAX package's runs (``transoar_tpu/training/
checkpoints.py``): the frozen run config ``config.json`` beside
``model_best_<metric>.pt`` (single best) and/or ``model_last.pt``. A
checkpoint holds the model's ``state_dict`` (reference parameter names),
written with ``torch.save`` and read back with ``weights_only=True``.
"""

from __future__ import annotations

import platform
from pathlib import Path

import torch

from transoar_tpu.utils.io import load_json, write_json


def save_checkpoint(path_to_run, name, model) -> Path:
    """Write ``<run>/<name>.pt``; a ``model_best*`` save replaces the
    previous best."""
    path_to_run = Path(path_to_run)
    path_to_run.mkdir(parents=True, exist_ok=True)
    if name.startswith("model_best"):
        for prev in path_to_run.glob("model_best*.pt"):
            prev.unlink()
    target = path_to_run / f"{name}.pt"
    torch.save(model.state_dict(), target)
    return target


def pick_checkpoint(path_to_run, prefer_best=True) -> Path:
    """Best (if present and preferred) else last."""
    path_to_run = Path(path_to_run)
    bests = sorted(path_to_run.glob("model_best*.pt"))
    if prefer_best and bests:
        return bests[-1]
    last = path_to_run / "model_last.pt"
    if last.exists():
        return last
    raise FileNotFoundError(f"no checkpoint found in {path_to_run}")


def load_checkpoint(path, device=None) -> dict:
    return torch.load(path, map_location=device, weights_only=True)


def freeze_run_config(config, path_to_run) -> None:
    path_to_run = Path(path_to_run)
    path_to_run.mkdir(parents=True, exist_ok=True)
    frozen = dict(config)
    frozen.update({"python_version": platform.python_version(),
                   "torch_version": torch.__version__})
    write_json(frozen, path_to_run / "config.json")


def load_run_config(path_to_run) -> dict:
    return load_json(Path(path_to_run) / "config.json")
