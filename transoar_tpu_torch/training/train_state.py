"""Optimizer, learning-rate schedule and gradient clipping (port of
``transoar_tpu/training/train_state.py``).

- AdamW with two groups: parameters whose name starts with ``_backbone.``
  (after a DDP wrapper's ``module.``) at ``lr_backbone``, the rest at
  ``lr``; betas 0.9/0.999, eps 1e-8 and the
  config's weight decay on every parameter. torch's AdamW decays by
  ``lr * wd * p`` and steps by ``lr * m_hat / (sqrt(v_hat) + eps)``, which
  is optax's ``adamw`` term for term.
- StepLR: both rates drop 10x once ``lr_drop * steps_per_epoch`` optimizer
  steps have been taken (optax's piecewise-constant schedule of the step
  count), stepped once per optimizer step.
- ``clip_grad_norm``: optax's ``clip_by_global_norm`` (scale by
  ``max_norm / norm`` when ``norm >= max_norm``), on the device, no sync.
  Under a multi-GPU ``Layout`` the gradients are shards: the squares are
  summed over the gradient group under FSDP2 (whose gradients are shards
  over dp, or dp x sp) and, for the tp shards, over the tp group
  (replicated gradients are whole on every tp rank, and under DDP on
  every sp rank, and counted once).
- ``UpdateRule``: one call's update after its backward. With
  ``trainer.grad_accum_steps`` k > 1 it is ``optax.MultiSteps`` around
  ``chain(clip, adamw groups)``: the calls' gradients are averaged
  (Welford: ``acc += (g - acc) / (n + 1)``), and every k-th call the clip,
  AdamW and the schedule step once on the mean (DTensor gradients under
  FSDP2 alike). Training checkpoints hold ``mini_step`` and the partial
  mean (``checkpoints.accumulation_state``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def lr_factor(step: int, config, steps_per_epoch: int) -> float:
    """The schedule's multiplier after ``step`` optimizer steps."""
    tcfg = config["trainer"]
    boundary = max(int(tcfg["lr_drop"]) * int(steps_per_epoch), 1)
    return 0.1 if step >= boundary else 1.0


def make_optimizer(model: torch.nn.Module, config, steps_per_epoch=1):
    """(AdamW, LambdaLR) for ``model`` under ``config['trainer']``."""
    tcfg = config["trainer"]
    backbone, rest = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            name = name.removeprefix("module.")  # under DDP
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


def _local(t):
    """A DTensor's local shard (a view of its storage), else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def _global_norm(grads, sharded, layout):
    """The global norm of gradient shards (``sharded``: tp shards)."""
    def squares(gs):
        return torch.stack([g.float().square().sum() for g in gs]).sum() \
            if gs else torch.zeros((), device=grads[0].device)

    sums = torch.stack([squares([g for g, s in zip(grads, sharded)
                                 if not s]),
                        squares([g for g, s in zip(grads, sharded) if s])])
    if layout.fsdp:
        dist.all_reduce(sums, group=layout.grad_group)
    replicated, shards = sums[0], sums[1].clone()
    if layout.tp > 1:
        dist.all_reduce(shards, group=layout.tp_group)
    return torch.sqrt(replicated + shards)


@torch.no_grad()
def clip_grad_norm(params, max_norm: float, layout=None,
                   sharded=None) -> torch.Tensor:
    """Scale the gradients in place to global norm ``max_norm`` when their
    norm is at least that; returns the norm before clipping. ``layout``:
    the run's ``parallel.mesh.Layout``; ``sharded``: which of ``params``
    are tp shards."""
    params = list(params)
    sharded = [False] * len(params) if sharded is None else list(sharded)
    keep = [i for i, p in enumerate(params) if p.grad is not None]
    grads = [_local(params[i].grad) for i in keep]
    if layout is None:
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
    else:
        norm = _global_norm(grads, [sharded[i] for i in keep], layout)
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def current_lrs(optimizer) -> dict:
    """The groups' learning rates for the next step, for logging."""
    return {g["name"]: float(g["lr"]) for g in optimizer.param_groups}


class UpdateRule:
    """Clip + AdamW + schedule after a call's backward, once every
    ``accum`` calls on the calls' mean gradient."""

    def __init__(self, optimizer, scheduler, params, clip=-1.0, accum=1,
                 layout=None, sharded=None):
        self.optimizer, self.scheduler = optimizer, scheduler
        self.params = list(params)
        self.layout, self.sharded = layout, sharded
        self.clip = float(clip)
        self.accum = int(accum)
        self.mini_step = 0
        self._acc = None

    @torch.no_grad()
    def _accumulate(self) -> bool:
        """Fold this call's gradients into the mean; on the k-th call put
        the mean into ``.grad`` and return True."""
        if self._acc is None:
            self._acc = [torch.zeros_like(p) for p in self.params]
        n = self.mini_step
        for p, acc in zip(self.params, self._acc):
            if p.grad is not None:
                acc.add_((p.grad - acc) / (n + 1))
            else:
                acc.sub_(acc / (n + 1))
        self.mini_step = (n + 1) % self.accum
        if self.mini_step:
            return False
        for p, acc in zip(self.params, self._acc):
            p.grad = acc.clone()
            acc.zero_()
        return True

    def __call__(self) -> bool:
        """Apply the update if this call completes one; returns whether it
        did."""
        if self.accum > 1 and not self._accumulate():
            return False
        if self.clip > 0:
            clip_grad_norm(self.params, self.clip, self.layout, self.sharded)
        self.optimizer.step()
        self.scheduler.step()
        return True
