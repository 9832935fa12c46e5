"""Run directories and checkpoints of the port.

Same layout as the JAX package's runs (``transoar_tpu/training/
checkpoints.py``): the frozen run config ``config.json`` beside
``model_best_<metric>.pt`` (single best) and ``model_last.pt``. Two kinds of
file, both written with ``torch.save`` and read with ``weights_only=True``:

- a training checkpoint (``save_training_checkpoint``): the model's
  ``state_dict`` (reference parameter names), the optimizer's and the
  scheduler's state, the epoch and the best metric so far and, with
  ``trainer.grad_accum_steps`` > 1, the accumulation (``accumulation``:
  the ``UpdateRule``'s count of calls and its partial mean gradient by
  parameter name, as the JAX package's ``opt_state`` holds
  ``optax.MultiSteps``'), so that ``restore_checkpoint`` resumes training
  exactly;
- a bare model ``state_dict`` (``save_checkpoint``), as a converted or
  seeded run holds.

``load_checkpoint`` returns the model's ``state_dict`` from either.

A multi-GPU run (a ``parallel.mesh.Layout``) writes the same file: the
full, unsharded state with the reference names (no DDP ``module.``
prefix, no DTensor, the tp shards and the packed ``in_proj_*`` chunks
reassembled) and the optimizer state in ``optimizer.state_dict()``'s own
layout, gathered by every rank (``get_model_state_dict`` /
``get_optimizer_state_dict`` with ``full_state_dict=True``, then the tp
all-gathers) and written by rank 0. Such a checkpoint loads unchanged into
one process (``predict``, ``test``, ``import_checkpoint``), and
``restore_checkpoint`` under a layout cuts it back into the rank's shards,
so a run resumes under any layout. The accumulation is saved whole by
parameter name alike. Spatial parallelism (``parallel/sp.py``) shards no
parameter: its ranks hold whole parameters (under FSDP2, shards of the
``dp x sp`` group), so these layouts need nothing more.
"""

from __future__ import annotations

import platform
from pathlib import Path

import torch

from transoar_tpu_torch.parallel import tp as tp_lib
from transoar_tpu_torch.parallel.fsdp import unwrap
from transoar_tpu_torch.utils.io import load_json, write_json


def _full():
    from torch.distributed.checkpoint.state_dict import StateDictOptions

    return StateDictOptions(full_state_dict=True)


def _target(path_to_run, name) -> Path:
    """``<run>/<name>.pt``; a ``model_best*`` name replaces the previous
    best (rank 0 only writes)."""
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


def model_state_dict(model, layout=None) -> dict:
    """The model's unsharded ``state_dict`` with the reference names; under
    a layout a collective of every rank."""
    if layout is None:
        return model.state_dict()
    from torch.distributed.checkpoint.state_dict import get_model_state_dict

    state = get_model_state_dict(model, options=_full())
    plan = getattr(unwrap(model), "tp_plan", {})
    state = tp_lib.gather_state(state, plan, layout.tp_group, layout.tp)
    return {k: v.cpu() for k, v in state.items()}


def _param_names(model):
    """{id(parameter): its name without DDP's ``module.``}."""
    return {id(p): n.removeprefix("module.")
            for n, p in model.named_parameters()}


def optimizer_state_dict(model, optimizer, layout=None) -> dict:
    """``optimizer.state_dict()``, and under a layout the same layout of
    the unsharded state (a collective of every rank)."""
    if layout is None or not optimizer.state:
        # before the first step there is nothing to gather (and
        # get_optimizer_state_dict would step the optimizer to make state)
        return optimizer.state_dict()
    from torch.distributed.checkpoint.state_dict import \
        get_optimizer_state_dict

    full = get_optimizer_state_dict(model, optimizer, options=_full())
    plan = getattr(unwrap(model), "tp_plan", {})
    names = _param_names(model)
    index, groups = {}, []
    for saved, group in zip(full["param_groups"], optimizer.param_groups):
        ids = []
        for p in group["params"]:
            index[names[id(p)]] = len(index)
            ids.append(index[names[id(p)]])
        groups.append(dict(saved, params=ids))

    def whole(fqn, v):
        if fqn in plan and torch.is_tensor(v) and v.dim():
            v = tp_lib.gather_tensor(v, plan[fqn], layout.tp_group,
                                     layout.tp)
        return v.cpu() if torch.is_tensor(v) else v

    state = {i: {k: whole(fqn, v) for k, v in full["state"][fqn].items()}
             for fqn, i in index.items()  # the same order on every rank
             if fqn in full["state"]}
    return {"state": state, "param_groups": groups}


def accumulation_state(model, update, layout=None) -> dict:
    """The ``UpdateRule``'s accumulation in the full-state layout:
    ``mini_step`` and ``mean`` {parameter name: whole tensor} (empty before
    the first call); under a layout a collective of every rank."""
    names = _param_names(model)
    plan = getattr(unwrap(model), "tp_plan", {})
    mean = {}
    for p, acc in zip(update.params, update._acc or ()):
        name = names[id(p)]
        acc = acc.full_tensor() if hasattr(acc, "full_tensor") else acc
        if name in plan:
            acc = tp_lib.gather_tensor(acc, plan[name], layout.tp_group,
                                       layout.tp)
        mean[name] = acc.cpu()
    return {"mini_step": int(update.mini_step), "mean": mean}


def load_accumulation(model, update, saved, layout=None) -> None:
    """Cut ``accumulation_state``'s record back into this rank's layout of
    ``update``'s parameters (tp shards, FSDP2 DTensors)."""
    update.mini_step = int(saved["mini_step"])
    if not saved["mean"]:
        update._acc = None
        return
    names = _param_names(model)
    plan = getattr(unwrap(model), "tp_plan", {})
    accs = []
    for p in update.params:
        name = names[id(p)]
        acc = saved["mean"][name].to(device=p.device, dtype=p.dtype)
        if name in plan:
            acc = tp_lib.shard_tensor(acc, *plan[name], layout.tp_rank,
                                      layout.tp)
        if hasattr(p, "device_mesh"):  # an FSDP2 DTensor
            from torch.distributed.tensor import distribute_tensor

            acc = distribute_tensor(acc, p.device_mesh, p.placements)
        accs.append(acc.clone())
    update._acc = accs


def save_training_checkpoint(path_to_run, name, model, optimizer, scheduler,
                             epoch, metric_max_val, layout=None,
                             update=None) -> Path:
    """Write model, optimizer, scheduler, epoch, best metric and, for an
    ``update`` rule that accumulates, its accumulation. Under a layout
    every rank calls it and rank 0 writes."""
    record = {"model": model_state_dict(model, layout),
              "optimizer": optimizer_state_dict(model, optimizer, layout),
              "scheduler": scheduler.state_dict(),
              "epoch": int(epoch),
              "metric_max_val": float(metric_max_val)}
    if update is not None and update.accum > 1:
        record["accumulation"] = accumulation_state(model, update, layout)
    if layout is None or layout.rank == 0:
        torch.save(record, _target(path_to_run, name))
    return Path(path_to_run) / f"{name}.pt"


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


def _load_sharded(obj, model, optimizer, layout):
    """Cut an unsharded training checkpoint into this rank's tp shards and
    hand it to the DDP / FSDP2 model and its optimizer."""
    from torch.distributed.checkpoint.state_dict import (
        set_model_state_dict, set_optimizer_state_dict)

    plan = getattr(unwrap(model), "tp_plan", {})
    set_model_state_dict(model, tp_lib.shard_state(
        obj["model"], plan, layout.tp_rank, layout.tp), options=_full())
    saved = obj["optimizer"]
    if not saved["state"]:  # saved before the first step
        optimizer.load_state_dict(saved)
        return
    names = _param_names(model)
    groups, state = [], {}
    for sg, group in zip(saved["param_groups"], optimizer.param_groups):
        fqns = [names[id(p)] for p in group["params"]]
        groups.append(dict(sg, params=fqns))
        for i, fqn in zip(sg["params"], fqns):
            if i in saved["state"]:
                state[fqn] = {
                    k: (tp_lib.shard_tensor(v, *plan[fqn], layout.tp_rank,
                                            layout.tp)
                        if fqn in plan and torch.is_tensor(v) and v.dim()
                        else v)
                    for k, v in saved["state"][i].items()}
    set_optimizer_state_dict(model, optimizer,
                             {"state": state, "param_groups": groups},
                             options=_full())


def restore_checkpoint(path, model, optimizer, scheduler, device=None,
                       layout=None, update=None):
    """Load a training checkpoint into ``model``, ``optimizer``,
    ``scheduler`` and, where it holds one, the accumulation into the
    ``update`` rule (under a layout: into the rank's shards); returns
    (epoch, metric_max_val)."""
    obj = torch.load(path, map_location=device, weights_only=True)
    if not _is_training_checkpoint(obj):
        raise ValueError(f"{path} holds model weights only; training "
                         f"resumes from a model_last or model_best file")
    if layout is None:
        model.load_state_dict(obj["model"])
        optimizer.load_state_dict(obj["optimizer"])
    else:
        _load_sharded(obj, model, optimizer, layout)
    scheduler.load_state_dict(obj["scheduler"])
    if update is not None and "accumulation" in obj:
        load_accumulation(model, update, obj["accumulation"], layout)
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
