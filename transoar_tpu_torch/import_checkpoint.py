"""Import a reference (torch) checkpoint into a run of the port (twin of
``scripts/import_torch_checkpoint.py``):

    python -m transoar_tpu_torch.import_checkpoint \
        --checkpoint /path/to/model_best_0.712.pt --config foc_dec_amos \
        [--name imported_run] [--data_dir D]

The port names its parameters exactly as the reference's ``state_dict``,
so the import is a strict ``load_state_dict`` into ``build_model(config)``:
a missing, unexpected or misshapen tensor raises. The Focused Decoder
family only (the flagship, its refine and seg-proxy variants, SwinFPN): a
``detr`` or ``def_detr`` config raises, as the reference's DETR branches
are not in this checkout, and so does one with a ``retina`` section (as
``scripts/import_torch_checkpoint.py``). It writes
``runs/<name>/`` with the frozen config and a training checkpoint
(``model_best_<metric>.pt`` when the file records a best metric, else
``model_last.pt``) that carries the file's epoch and best metric and a
fresh AdamW and schedule: the reference's optimizer moments are not
imported, which matters only when training resumes from the run. The run
then serves ``test`` and ``predict`` and resumes with ``train --resume``.
Host only.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch

from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.training import checkpoints as ckpt_lib
from transoar_tpu_torch.training.train_state import make_optimizer
from transoar_tpu_torch.utils.io import (get_config, set_root_logger,
                                         validate_config)

logger = logging.getLogger(__name__)


def load_reference_state_dict(path):
    """A reference checkpoint file -> (state_dict, epoch, best metric).

    Takes the reference trainer's payload (``model_state_dict`` beside
    ``epoch`` and ``metric_max_val``, reference trainer.py:235-241) or a
    bare ``state_dict``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    epoch, best = 0, 0.0
    if isinstance(payload, dict) and "model_state_dict" in payload:
        epoch = int(payload.get("epoch", 0))
        best = float(payload.get("metric_max_val", 0.0))
        payload = payload["model_state_dict"]
    return payload, epoch, best


def import_checkpoint(config, state_dict, epoch, best, run_name):
    """Load ``state_dict`` strictly into the model of ``config`` and write
    the run; returns the checkpoint's path."""
    neck = config["neck"].get("name", "foc_attn")
    if neck != "foc_attn" or "retina" in config:
        model = "RetinaNet" if "retina" in config else f"the {neck} neck"
        raise ValueError(
            f"no reference checkpoint layout for {model}: the reference's "
            f"DETR and retina-unet branches are not in this checkout, so "
            f"their parameter names are unknown; import_checkpoint reads the "
            f"Focused Decoder family only (as "
            f"scripts/import_torch_checkpoint.py)")
    model = build_model(config, device="cpu")
    model.load_state_dict(state_dict, strict=True)
    optimizer, scheduler = make_optimizer(model, config)
    path_to_run = Path.cwd() / "runs" / run_name
    ckpt_lib.freeze_run_config(config, path_to_run)
    name = f"model_best_{best:.3f}" if best else "model_last"
    target = ckpt_lib.save_training_checkpoint(
        path_to_run, name, model, optimizer, scheduler, epoch, best)
    logger.info("imported %d tensors -> %s (epoch %d, best %.3f)",
                len(state_dict), target, epoch, best)
    return target


def main(argv=None):
    """Import ``--checkpoint``; returns the written checkpoint's path."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Path to the reference .pt checkpoint.")
    parser.add_argument("--config", type=str, required=True,
                        help="Config name in ./config (without .yaml), or a "
                             ".yaml path; must match the architecture the "
                             "checkpoint was trained with.")
    parser.add_argument("--name", type=str, default=None,
                        help="Run name (default: imported_<experiment>).")
    parser.add_argument("--data_dir", type=str, default=None,
                        help="Dataset root (default ./dataset).")
    args = parser.parse_args(argv)

    set_root_logger(Path.cwd() / "logs" / "import.log")
    config = validate_config(get_config(args.config,
                                        dataset_dir=args.data_dir))
    run_name = args.name or f"imported_{config['experiment_name']}"
    config = {**config, "experiment_name": run_name}
    state_dict, epoch, best = load_reference_state_dict(args.checkpoint)
    target = import_checkpoint(config, state_dict, epoch, best, run_name)
    print(f"run ready: runs/{run_name} (evaluate with: python -m "
          f"transoar_tpu_torch.test --run {run_name})")
    return target


if __name__ == "__main__":
    main()
