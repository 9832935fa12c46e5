"""The data-parallel wrappers of the dp axis: ``parallel.fsdp: true`` as
FSDP2, plain dp as ``DistributedDataParallel``, both over the gradient
group (``Layout.grad_group``: dp, or the flattened ``dp x sp`` under
spatial parallelism, ``parallel/sp.py``), on top of the sp context and the
tp shards (``parallel/tp.py``).

- FSDP2 (``fully_shard``) is the counterpart of the JAX
  ``state_shardings(..., fsdp=True)`` (``transoar_tpu/parallel/tp.py``):
  weights, gradients and the AdamW moments live as dp shards (DTensors);
  each unit all-gathers its weights for its forward (and again for the
  remat's recompute and the backward) and reduce-scatters the mean
  gradient. Units: each encoder stage, each decoder layer, then the root.
  The forward sees plain unsharded tensors, so the custom kernels do too.
- DDP all-reduces the mean gradient; its buffers (anchors, the attention
  bias) are constants, so they are not broadcast each step. Every
  parameter gets a gradient each step (zero-initialised heads included),
  and the encoder's remat is ``checkpoint(use_reentrant=False)``, which DDP
  follows, so neither ``find_unused_parameters`` nor ``static_graph`` is
  needed.

Either wrapper averages the gradient over its group; the train step scales
the loss by dp so that the gradient is that of the global-batch loss
(``training/trainer.make_train_step``; under sp the gather's backward
supplies the factor sp, ``parallel/sp.py``).
"""

from __future__ import annotations

import torch

from transoar_tpu_torch.parallel import sp as sp_lib
from transoar_tpu_torch.parallel import tp as tp_lib


def unwrap(model):
    """The model under a DDP wrapper (FSDP2 wraps in place)."""
    return getattr(model, "module", model)


def fsdp_units(model):
    """The modules FSDP2 shards as units before the root: each encoder
    stage and each decoder layer of the neck."""
    units = list(model._backbone._encoder._stages)
    neck = getattr(model, "_neck", None)
    if neck is not None:
        layers = (neck.decoder["layers"] if hasattr(neck, "decoder")
                  else neck.layers)
        units += list(layers)
    return units


def apply_fsdp(model, layout):
    from torch.distributed.fsdp import fully_shard

    mesh = layout.grad_mesh
    for unit in fsdp_units(model):
        fully_shard(unit, mesh=mesh)
    fully_shard(model, mesh=mesh)
    return model


def apply_ddp(model, layout, device):
    from torch.nn.parallel import DistributedDataParallel

    device = torch.device(device)
    return DistributedDataParallel(
        model, process_group=layout.grad_group,
        device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False)


def parallelize(model, layout, device, tp_always=False):
    """Hand the modules their sp context (when ``layout.sp > 1``), shard
    the neck over tp (when ``layout.tp > 1``, or at any size with
    ``tp_always``), then wrap in FSDP2 (``layout.fsdp``) or DDP over the
    gradient group. Returns the model to train; ``unwrap`` gives the
    module under it."""
    if layout.sp > 1:
        sp_lib.apply_sp(model, layout)
    if layout.tp > 1 or tp_always:
        tp_lib.apply_tp(model, layout.tp_group, layout.tp_rank, layout.tp)
    if layout.fsdp:
        return apply_fsdp(model, layout)
    return apply_ddp(model, layout, device)

