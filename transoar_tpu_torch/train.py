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

Multi-GPU, one process per card:

    torchrun --nproc_per_node=N -m transoar_tpu_torch.train --config <name>

reads torchrun's environment (``parallel.mesh.init_distributed``: NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``), lays the ranks out by
the config's ``parallel`` section (``dp``, ``sp``, ``tp``, ``fsdp``),
loads each rank's rows of every global batch, hands the model's modules
their block of the volume's S0 over sp (a shape ``parallel.sp.sp_plan``
forbids raises before the first step), shards the neck over tp and wraps
the model in FSDP2 or DDP (``parallel.fsdp``). Only
rank 0 logs to the run's log and writes the run directory; the process
group is torn down at the end. Without torchrun's environment nothing of
this happens.
"""

from __future__ import annotations

import argparse
import logging
import random
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from transoar_tpu_torch.data.dataset import get_loader
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.parallel.fsdp import parallelize
from transoar_tpu_torch.parallel.mesh import (init_distributed,
                                              layout_from_config,
                                              local_batch_rows)
from transoar_tpu_torch.training import checkpoints as ckpt_lib
from transoar_tpu_torch.training.train_state import make_optimizer
from transoar_tpu_torch.training.trainer import Trainer
from transoar_tpu_torch.utils.io import (get_config, set_root_logger,
                                         validate_config)

logger = logging.getLogger(__name__)


def train(config, args, **trainer_options):
    """Build everything from ``config`` and train; returns the Trainer.
    ``trainer_options`` go to the Trainer (its measurement options). In a
    process group (torchrun) the run is laid out by ``parallel``."""
    device = torch.device(args.device)
    layout = layout_from_config(config, device)
    rows = local_batch_rows(layout, config["trainer"]["batch_size"])
    train_loader = get_loader(config, "train", data_dir=args.data_dir,
                              rows=rows)
    # every rank validates on the whole split, as the JAX trainer
    val_split = "train" if config.get("overfit") else "val"
    val_loader = get_loader(config, val_split, data_dir=args.data_dir)

    generator = torch.Generator().manual_seed(int(config["seed"]))
    model = build_model(config, device=device, generator=generator)
    logger.info("model parameters: %.2fM",
                sum(p.numel() for p in model.parameters()) / 1e6)
    if layout is not None:
        logger.info("mesh dp %d x sp %d x tp %d, %s", layout.dp, layout.sp,
                    layout.tp, "FSDP2" if layout.fsdp else "DDP")
        model = parallelize(model, layout, device)
    optimizer, scheduler = make_optimizer(model, config,
                                          max(len(train_loader), 1))

    path_to_run = Path.cwd() / "runs" / config["experiment_name"]
    resume_from = args.resume
    if not resume_from and args.auto_resume:
        last = path_to_run / "model_last.pt"
        if last.exists():
            resume_from = last
        else:
            logger.info("--auto_resume: no checkpoint at %s, fresh start",
                        last)
    trainer = Trainer(config, model, train_loader, val_loader, path_to_run,
                      device, optimizer, scheduler, layout=layout,
                      **trainer_options)
    if resume_from:
        epoch, metric_start_val = trainer.resume(resume_from)
        logger.info("resumed from %s at epoch %d (best %.3f)", resume_from,
                    epoch, metric_start_val)
    if layout is None or layout.rank == 0:
        ckpt_lib.freeze_run_config(config, path_to_run)
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
                        help="Torch device of the run (default cuda; "
                             "cuda:LOCAL_RANK under torchrun).")
    args = parser.parse_args(argv)

    device = init_distributed(args.device)
    if device is not None:
        args.device = str(device)
    try:
        config = validate_config(get_config(args.config,
                                            dataset_dir=args.data_dir))
        np.random.seed(config["seed"])
        random.seed(config["seed"])
        torch.manual_seed(config["seed"])

        if device is None or dist.get_rank() == 0:
            set_root_logger(Path.cwd() / "logs" / "train.log")
        return train(config, args)
    finally:
        if device is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
