"""Run directories and checkpoints of the port.

Same layout as the JAX package's runs (``transoar_tpu/training/
checkpoints.py``): the frozen run config ``config.json`` beside
``model_best_<metric>.pt`` (single best) and ``model_last.pt``. Two kinds of
file, both written with ``torch.save`` and read with ``weights_only=True``:

- a training checkpoint (``save_training_checkpoint``): the model's
  ``state_dict`` (reference parameter names), the optimizer's and the
  scheduler's state, the epoch and the best metric so far, so that
  ``restore_checkpoint`` resumes training exactly;
- a bare model ``state_dict`` (``save_checkpoint``), as a converted or
  seeded run holds.

``load_checkpoint`` returns the model's ``state_dict`` from either.
"""

from __future__ import annotations

import platform
from pathlib import Path

import torch

from transoar_tpu_torch.utils.io import load_json, write_json


def _target(path_to_run, name) -> Path:
    """``<run>/<name>.pt``; a ``model_best*`` name replaces the previous
    best."""
    path_to_run = Path(path_to_run)
    path_to_run.mkdir(parents=True, exist_ok=True)
    if name.startswith("model_best"):
        for prev in path_to_run.glob("model_best*.pt"):
            prev.unlink()
    return path_to_run / f"{name}.pt"


def save_checkpoint(path_to_run, name, model) -> Path:
    """Write the model's ``state_dict`` alone to ``<run>/<name>.pt``."""
    target = _target(path_to_run, name)
    torch.save(model.state_dict(), target)
    return target


def save_training_checkpoint(path_to_run, name, model, optimizer, scheduler,
                             epoch, metric_max_val) -> Path:
    """Write model, optimizer, scheduler, epoch and best metric."""
    target = _target(path_to_run, name)
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict(),
                "epoch": int(epoch),
                "metric_max_val": float(metric_max_val)}, target)
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


def _is_training_checkpoint(obj) -> bool:
    return isinstance(obj, dict) and {"model", "epoch"} <= set(obj)


def load_checkpoint(path, device=None) -> dict:
    """The model ``state_dict`` of either kind of checkpoint."""
    obj = torch.load(path, map_location=device, weights_only=True)
    return obj["model"] if _is_training_checkpoint(obj) else obj


def restore_checkpoint(path, model, optimizer, scheduler, device=None):
    """Load a training checkpoint into ``model``, ``optimizer`` and
    ``scheduler``; returns (epoch, metric_max_val)."""
    obj = torch.load(path, map_location=device, weights_only=True)
    if not _is_training_checkpoint(obj):
        raise ValueError(f"{path} holds model weights only; training "
                         f"resumes from a model_last or model_best file")
    model.load_state_dict(obj["model"])
    optimizer.load_state_dict(obj["optimizer"])
    scheduler.load_state_dict(obj["scheduler"])
    return obj["epoch"], obj["metric_max_val"]


def freeze_run_config(config, path_to_run) -> None:
    path_to_run = Path(path_to_run)
    path_to_run.mkdir(parents=True, exist_ok=True)
    frozen = dict(config)
    frozen.update({"python_version": platform.python_version(),
                   "torch_version": torch.__version__})
    write_json(frozen, path_to_run / "config.json")


def load_run_config(path_to_run) -> dict:
    return load_json(Path(path_to_run) / "config.json")
