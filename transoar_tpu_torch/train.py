"""Training CLI of the port (twin of ``scripts/train.py``, plus
``--device``):

    python -m transoar_tpu_torch.train --config <name> [--resume P] \
        [--auto_resume] [--data_dir D] [--device cuda]

Loads ``config/<name>.yaml`` (or a ``.yaml`` path) with the dataset's
``data_info.json`` merged, seeds everything, builds the loaders, the model
(parameters drawn from a generator seeded with ``config['seed']``), AdamW
and the schedule, restores ``--resume`` (or, with ``--auto_resume``,
``runs/<experiment>/model_last.pt`` if it exists), freezes the run config
to ``runs/<experiment>/config.json`` and runs the ``Trainer``. Runs on
``cuda`` unless asked for the CPU.
"""

from __future__ import annotations

import argparse
import logging
import random
from pathlib import Path

import numpy as np
import torch

from transoar_tpu_torch.data.dataset import get_loader
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.training import checkpoints as ckpt_lib
from transoar_tpu_torch.training.train_state import make_optimizer
from transoar_tpu_torch.training.trainer import Trainer
from transoar_tpu_torch.utils.io import (get_config, set_root_logger,
                                         validate_config)

logger = logging.getLogger(__name__)


def train(config, args):
    """Build everything from ``config`` and train; returns the Trainer."""
    device = torch.device(args.device)
    train_loader = get_loader(config, "train", data_dir=args.data_dir)
    val_split = "train" if config.get("overfit") else "val"
    val_loader = get_loader(config, val_split, data_dir=args.data_dir)

    generator = torch.Generator().manual_seed(int(config["seed"]))
    model = build_model(config, device=device, generator=generator)
    optimizer, scheduler = make_optimizer(model, config,
                                          max(len(train_loader), 1))
    logger.info("model parameters: %.2fM",
                sum(p.numel() for p in model.parameters()) / 1e6)

    path_to_run = Path.cwd() / "runs" / config["experiment_name"]
    resume_from = args.resume
    if not resume_from and args.auto_resume:
        last = path_to_run / "model_last.pt"
        if last.exists():
            resume_from = last
        else:
            logger.info("--auto_resume: no checkpoint at %s, fresh start",
                        last)
    epoch, metric_start_val = 0, 0.0
    if resume_from:
        epoch, metric_start_val = ckpt_lib.restore_checkpoint(
            resume_from, model, optimizer, scheduler, device)
        logger.info("resumed from %s at epoch %d (best %.3f)", resume_from,
                    epoch, metric_start_val)
    ckpt_lib.freeze_run_config(config, path_to_run)

    trainer = Trainer(config, model, train_loader, val_loader, path_to_run,
                      device, optimizer, scheduler, start_epoch=epoch,
                      metric_start_val=metric_start_val)
    trainer.run()
    return trainer


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True,
                        help="Config name in ./config (without .yaml), or a "
                             ".yaml path.")
    parser.add_argument("--resume", type=str, default=None,
                        help="Training checkpoint (.pt) to resume from.")
    parser.add_argument("--auto_resume", action="store_true",
                        help="Resume from runs/<experiment>/model_last.pt if "
                             "it exists, else start fresh.")
    parser.add_argument("--data_dir", type=str, default=None,
                        help="Dataset root (default ./dataset).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device of the run (default cuda).")
    args = parser.parse_args(argv)

    config = validate_config(get_config(args.config,
                                        dataset_dir=args.data_dir))
    np.random.seed(config["seed"])
    random.seed(config["seed"])
    torch.manual_seed(config["seed"])

    set_root_logger(Path.cwd() / "logs" / "train.log")
    return train(config, args)


if __name__ == "__main__":
    main()
