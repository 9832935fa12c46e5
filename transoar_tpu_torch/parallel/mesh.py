"""Process layout of a multi-GPU run (port of
``transoar_tpu/parallel/mesh.py``).

``torchrun`` starts one process per card; each reads ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` and joins one process group
(``init_distributed``). The processes form a ``dp x sp x tp`` device mesh
with the JAX package's axis names, in its row-major order
(rank = (dp index * sp + sp index) * tp + tp index):

  dp: data parallel. Each dp index loads its own rows of every global
      batch (``local_batch_rows``); DDP or FSDP2 averages the gradients
      (``parallel/fsdp.py``).
  sp: spatial parallel. The volume's leading spatial axis is split into
      ``sp`` equal blocks; the encoder and the FPN run on the rank's block
      with halo exchanges, the neck and the heads on gathered tensors
      (``parallel/sp.py``). Every sp rank of one dp index loads the same
      rows; the gradient wrapper averages over the flattened ``dp x sp``
      group (``Layout.grad_group``).
  tp: tensor parallel. The transformer neck's attention heads and FFN
      hidden units are split Megatron-style over the tp group
      (``parallel/tp.py``); every tp rank of one dp index loads the same
      rows.

A run without torchrun's environment builds no process group, no mesh and
no ``Layout``: every function here then returns None and the model is not
wrapped.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist

from transoar_tpu_torch.parallel.sp import SPShard

def init_distributed(device="cuda", backend=None):
    """Join the process group torchrun describes; returns this process's
    device, or None without torchrun's environment (no ``WORLD_SIZE``).

    ``cuda`` becomes ``cuda:LOCAL_RANK`` (an explicit index is kept). The
    backend is NCCL on a card and gloo on the CPU unless ``backend`` says
    otherwise (two processes sharing one card need gloo: NCCL refuses two
    ranks on one device)."""
    if "WORLD_SIZE" not in os.environ:
        return None
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return device


def make_mesh(dp=-1, sp=1, tp=1, device_type="cpu"):
    """The ``("dp", "sp", "tp")`` DeviceMesh over every rank of the process
    group: rank = (dp index * sp + sp index) * tp + tp index, the JAX
    mesh's row-major order. ``dp: -1`` takes the ranks ``sp`` and ``tp``
    leave; a mesh that does not cover the world raises."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    sp, tp = max(int(sp), 1), max(int(tp), 1)
    dp = world // (sp * tp) if int(dp) == -1 else int(dp)
    if dp * sp * tp != world:
        raise ValueError(f"mesh {dp}x{sp}x{tp} does not cover {world} ranks")
    return init_device_mesh(device_type, (dp, sp, tp),
                            mesh_dim_names=("dp", "sp", "tp"))


def mesh_from_config(config, device_type="cpu"):
    par = config.get("parallel", {}) or {}
    return make_mesh(par.get("dp", -1), par.get("sp", 1), par.get("tp", 1),
                     device_type)


def auto_mesh(batch_size, tp=1, device_type="cpu"):
    """The largest dp axis that divides the batch, as the JAX ``auto_mesh``.
    The JAX mesh drops the devices left over; a process cannot be dropped,
    so a batch that leaves ranks idle raises."""
    world = dist.get_world_size()
    tp = max(int(tp), 1)
    dp = math.gcd(int(batch_size), world // tp)
    if dp * tp != world:
        raise ValueError(
            f"batch {batch_size} splits over {dp} of the {world // tp} dp "
            f"ranks: pick a batch the dp axis divides")
    return make_mesh(dp, 1, tp, device_type)


class Layout:
    """This process's place in the run: the mesh, the sizes, ranks and
    groups of its three axes, whether FSDP2 shards the weights and the
    AdamW moments (``parallel.fsdp``), and the mesh and group of the
    gradient wrapper: dp alone, or under sp the flattened ``dp x sp``
    (``grad_mesh``, ``grad_group``; ``parallel/sp.py`` says why).
    ``sp_shard``: the sp modules' context, None at sp = 1."""

    def __init__(self, mesh, fsdp=False):
        self.mesh = mesh
        self.fsdp = bool(fsdp)
        self.dp, self.sp, self.tp = (mesh[a].size() for a in ("dp", "sp",
                                                                "tp"))
        self.dp_rank = mesh.get_local_rank("dp")
        self.sp_rank = mesh.get_local_rank("sp")
        self.tp_rank = mesh.get_local_rank("tp")
        self.dp_group = mesh.get_group("dp")
        self.sp_group = mesh.get_group("sp")
        self.tp_group = mesh.get_group("tp")
        self.grad_mesh = mesh["dp"] if self.sp == 1 else \
            mesh["dp", "sp"]._flatten("dp_sp")
        self.grad_group = self.grad_mesh.get_group()
        self.sp_shard = None if self.sp == 1 else SPShard(
            self.sp_group, self.sp_rank, self.sp)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()

    def generator_seed(self, seed):
        """The seed of this rank's dropout and on-device augmentation
        generator: ``seed`` on dp index 0 (what one process draws) and a
        hash of (seed, dp index) elsewhere, so that dp ranks draw different
        masks for their different rows while the tp ranks of one dp index,
        and the sp ranks, which hold the same rows, draw the same."""
        if self.dp_rank == 0:
            return int(seed)
        state = np.random.SeedSequence([int(seed), self.dp_rank])
        return int(state.generate_state(1, np.uint64)[0] >> 1)


def layout_from_config(config, device):
    """The run's Layout: ``parallel.dp: -1`` with ``sp: 1`` takes
    ``auto_mesh`` over the batch (with the config's ``tp``), anything else
    ``mesh_from_config``; None without a process group."""
    if not dist.is_initialized():
        return None
    par = config.get("parallel", {}) or {}
    device_type = torch.device(device).type
    if par.get("dp", -1) == -1 and par.get("sp", 1) == 1:
        mesh = auto_mesh(config["trainer"]["batch_size"], par.get("tp", 1),
                         device_type)
    else:
        mesh = mesh_from_config(config, device_type)
    return Layout(mesh, fsdp=par.get("fsdp", False))


def local_batch_rows(layout, batch_size):
    """The rows of every global batch this process loads, or None in a
    one-process run: the block of ``batch_size / dp`` rows its dp index
    consumes (``NamedSharding(mesh, P("dp"))``'s index map); every sp and
    tp rank of one dp index loads the same rows."""
    if layout is None or layout.world == 1:
        return None
    if int(batch_size) % layout.dp:
        raise ValueError(f"batch {batch_size} does not split over dp = "
                         f"{layout.dp}")
    n = int(batch_size) // layout.dp
    return np.arange(layout.dp_rank * n, (layout.dp_rank + 1) * n,
                     dtype=np.int64)
