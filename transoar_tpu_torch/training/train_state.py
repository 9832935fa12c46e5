"""Optimizer, learning-rate schedule and gradient clipping (port of
``transoar_tpu/training/train_state.py``).

- AdamW with two groups: parameters whose name starts with ``_backbone.``
  at ``lr_backbone``, the rest at ``lr``; betas 0.9/0.999, eps 1e-8 and the
  config's weight decay on every parameter. torch's AdamW decays by
  ``lr * wd * p`` and steps by ``lr * m_hat / (sqrt(v_hat) + eps)``, which
  is optax's ``adamw`` term for term.
- StepLR: both rates drop 10x once ``lr_drop * steps_per_epoch`` optimizer
  steps have been taken (optax's piecewise-constant schedule of the step
  count), stepped once per optimizer step.
- ``clip_grad_norm``: optax's ``clip_by_global_norm`` (scale by
  ``max_norm / norm`` when ``norm >= max_norm``), on the device, no sync.
"""

from __future__ import annotations

import torch


def lr_factor(step: int, config, steps_per_epoch: int) -> float:
    """The schedule's multiplier after ``step`` optimizer steps."""
    tcfg = config["trainer"]
    boundary = max(int(tcfg["lr_drop"]) * int(steps_per_epoch), 1)
    return 0.1 if step >= boundary else 1.0


def make_optimizer(model: torch.nn.Module, config, steps_per_epoch=1):
    """(AdamW, LambdaLR) for ``model`` under ``config['trainer']``."""
    tcfg = config["trainer"]
    if int(tcfg.get("grad_accum_steps", 1)) > 1:
        raise NotImplementedError(
            "trainer.grad_accum_steps > 1 is not ported: raise "
            "trainer.batch_size instead")
    backbone, rest = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (backbone if name.startswith("_backbone.") else rest).append(p)
    groups = [{"params": backbone, "lr": float(tcfg["lr_backbone"]),
               "name": "backbone"},
              {"params": rest, "lr": float(tcfg["lr"]), "name": "neck"}]
    optimizer = torch.optim.AdamW(
        groups, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=float(tcfg["weight_decay"]))
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: lr_factor(step, config, steps_per_epoch))
    return optimizer, scheduler


@torch.no_grad()
def clip_grad_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place to global norm ``max_norm`` when their
    norm is at least that; returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def current_lrs(optimizer) -> dict:
    """The groups' learning rates for the next step, for logging."""
    return {g["name"]: float(g["lr"]) for g in optimizer.param_groups}
