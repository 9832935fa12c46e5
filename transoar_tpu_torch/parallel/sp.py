"""Spatial parallelism over the mesh's ``sp`` axis, by hand (the JAX mesh's
``sp``, ``transoar_tpu/parallel/mesh.py``, which GSPMD partitions by
itself).

The volume ``[B, S0, S1, S2, C]`` is split along S0 into ``sp`` equal
contiguous blocks, rank ``sp_rank`` holding rows
``[sp_rank * L, (sp_rank + 1) * L)``. The encoder and the FPN run on the
rank's block: a conv over S0 takes its neighbours' edge rows (``halo``),
the depth-packed band conv its neighbours' packed rows, InstanceNorm sums
its statistics over the ranks (``all_reduce``), a shifted Swin window
rolls across the ranks (``roll``). Whatever reads across the whole volume
runs on whole tensors, replicated over sp, after a ``gather``: the neck
and the heads, the deformable refine, RetinaNet's towers, and every Swin
stage from the first whose windows or merge do not split (``sp_plan``).
The FPN's top-down path takes its slice of a gathered level with
``scatter``. The model's outputs are whole and the same on every sp
rank, so the criterion, the matcher and the targets do not change.

**The gradient design** (the choice every collective's backward follows):
DDP or FSDP2 run over the flattened ``dp x sp`` group
(``Layout.grad_group``) and average there. On every rank, the gradient of
a whole (replicated) tensor is the whole gradient, and the gradient of a
sharded tensor is ``sp`` times the rank's slice of the whole gradient:

- ``gather``'s backward returns ``sp`` x the rank's slice of the whole
  gradient (no communication: it is the same on every sp rank);
- ``scatter``'s backward all-gathers the slices and divides by ``sp``;
- ``halo``'s backward adds each neighbour's halo gradient into the edge
  rows it came from, and ``all_reduce``'s backward all-reduces; both are
  linear, so the factor ``sp`` passes through.

A parameter of the replicated part then has the whole gradient on every
sp rank, and one of the sharded part ``sp`` x its rank's partial, whose
sum over sp is the whole gradient; the average over ``dp x sp`` gives the
global batch's gradient for both (with the loss scaled by dp, as without
sp). The clip's norm counts each element once: under DDP every rank holds
the whole averaged gradient, under FSDP2 the squares are summed over the
same group (``training/train_state.py``).

Every primitive is a ``torch.autograd.Function`` over one all-gather or
all-reduce of the sp group, which gloo and NCCL both provide for CPU and
CUDA tensors. No module of the sharded part draws elementwise dropout
(DropPath is one draw per sample, the same on every sp rank); the sp ranks
of one dp index share their generator's seed
(``Layout.generator_seed``), so they draw alike.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class SPShard:
    """What a sharded module needs: the sp group, this rank's index in it
    and the group's size."""

    def __init__(self, group, rank, size):
        self.group, self.rank, self.size = group, rank, size


def _all_gather(x, shard):
    parts = [torch.empty_like(x) for _ in range(shard.size)]
    dist.all_gather(parts, x.contiguous(), group=shard.group)
    return parts


def _edges(x, lo, hi):
    """The rows a rank sends for a halo of (lo, hi) along axis 1: its
    first ``hi`` rows (the previous rank's ``hi`` halo), then its last
    ``lo`` rows (the next rank's ``lo`` halo)."""
    return torch.cat([x[:, :hi], x[:, x.shape[1] - lo:]], 1)


def _with_halo(x, edges, lo, hi, rank, size, wrap):
    """``x`` with the previous rank's last ``lo`` rows before it and the
    next rank's first ``hi`` rows after it, from every rank's ``_edges``;
    zeros beyond the volume's ends unless ``wrap``."""
    first, last = rank == 0 and not wrap, rank == size - 1 and not wrap
    below = edges[(rank - 1) % size][:, hi:]
    above = edges[(rank + 1) % size][:, :hi]
    return torch.cat([torch.zeros_like(below) if first else below, x,
                      torch.zeros_like(above) if last else above], 1)


class _Halo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, lo, hi, wrap, shard):
        ctx.lo, ctx.hi, ctx.wrap, ctx.shard = lo, hi, wrap, shard
        return _with_halo(x, _all_gather(_edges(x, lo, hi), shard), lo, hi,
                          shard.rank, shard.size, wrap)

    @staticmethod
    def backward(ctx, grad):
        lo, hi, shard = ctx.lo, ctx.hi, ctx.shard
        r, n = shard.rank, shard.size
        L = grad.shape[1] - lo - hi
        gx = grad[:, lo:lo + L].clone()
        # my lo rows' gradient belongs to the previous rank's last lo rows,
        # my hi rows' to the next rank's first hi rows
        parts = _all_gather(torch.cat([grad[:, :lo], grad[:, lo + L:]], 1),
                            shard)
        if r < n - 1 or ctx.wrap:
            gx[:, L - lo:] += parts[(r + 1) % n][:, :lo]
        if r > 0 or ctx.wrap:
            gx[:, :hi] += parts[(r - 1) % n][:, lo:]
        return gx, None, None, None, None


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return torch.cat(_all_gather(x, shard), 1)

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        L = grad.shape[1] // shard.size
        return grad.narrow(1, shard.rank * L, L) * shard.size, None


class _Scatter(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        L = x.shape[1] // shard.size
        return x.narrow(1, shard.rank * L, L).clone()

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(_all_gather(grad, ctx.shard), 1) / ctx.shard.size, \
            None


class _AllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        x = x.clone()
        dist.all_reduce(x, group=shard.group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.shard.group)
        return grad, None


def halo(x, lo, hi, shard, wrap=False):
    """``x`` [B, L, ...] with the previous rank's last ``lo`` rows before
    it and the next rank's first ``hi`` rows after it along axis 1
    ([B, lo + L + hi, ...]); zeros beyond the volume's two ends, or, with
    ``wrap``, the rows of the other end (the last rank's before rank 0)."""
    if max(lo, hi) > x.shape[1]:
        raise ValueError(f"a halo of ({lo}, {hi}) rows needs a local extent "
                         f"of at least that, got {x.shape[1]}")
    return _Halo.apply(x, lo, hi, wrap, shard)


def gather(x, shard):
    """The whole tensor of the sp ranks' blocks along axis 1."""
    return _Gather.apply(x, shard)


def scatter(x, shard):
    """This rank's block along axis 1 of a whole (replicated) tensor."""
    return _Scatter.apply(x, shard)


def all_reduce(x, shard):
    """The sum of ``x`` over the sp ranks (InstanceNorm's statistics)."""
    return _AllReduce.apply(x, shard)


def roll(x, shift, shard):
    """The global cyclic roll of the sharded axis 1 by ``shift`` rows
    (``torch.roll(whole, shift, 1)``'s block of this rank): a halo of
    ``|shift|`` rows that wraps from the last rank to the first."""
    L = x.shape[1]
    if shift > 0:
        return halo(x, shift, 0, shard, wrap=True)[:, :L]
    if shift < 0:
        return halo(x, 0, -shift, shard, wrap=True)[:, -shift:]
    return x


def sp_plan(config, patch_size, sp):
    """Which encoder stages run on the rank's block (``"sharded"``) and
    which on whole tensors (``"gathered"``), for the backbone ``config`` at
    input ``patch_size`` over ``sp`` ranks: a pure shape rule, the same on
    every rank.

    The S0 extent must split into ``sp`` equal blocks. A CNN stage runs
    sharded; its local extent must be a multiple of ``stage0_pack`` where
    the stage packs, and even before a stride-2 conv. A Swin stage runs
    sharded while the rank's block holds whole windows (the window taken on
    the global extent, as one process clamps it) and an even extent for
    its merge; from the first that does not, it and every later stage run
    gathered. Any other shape raises a ``ValueError`` that names the
    constraint, before the first step."""
    sp = int(sp)
    depth = int(patch_size[0])
    if depth % sp:
        raise ValueError(f"sp: the S0 extent {depth} does not split into "
                         f"{sp} equal blocks")
    num_stages = config["num_stages"]
    swin_from = 2 if config.get("use_encoder_attn") else num_stages
    kernel = config.get("kernel_size", 3)
    pack = int(config.get("stage0_pack", 0))
    plan, gathered = [], False
    for s in range(num_stages):
        local = depth // sp
        if s >= swin_from:
            window = min(depth, int(config["swin"]["window_size"][0]))
            gathered = gathered or bool(local % window or local % 2)
            depth = -(-depth // 2)
        else:
            stride = tuple(config["strides"][s])
            if pack and stride == (1, 1, 1) and kernel == 3 and local % pack:
                raise ValueError(
                    f"sp = {sp}: the local depth {local} of stage {s} is not "
                    f"a multiple of stage0_pack = {pack}")
            if local % stride[0]:
                raise ValueError(
                    f"sp = {sp}: odd local extent {local} before the "
                    f"stride-{stride[0]} conv of stage {s}")
            depth = -(-depth // stride[0])
        plan.append("gathered" if gathered else "sharded")
    return plan


def apply_sp(model, layout):
    """Hand every module of ``model`` (TransoarNet or RetinaNet, unwrapped)
    that meets the sharded axis its sp context: the encoder's sharded
    stages' convs (halos), norms (statistics) and Swin blocks (windows),
    the encoder (where it gathers) and the decoder (which levels are
    sharded, which the model's gathers before the neck and the heads read;
    its sharded out convs). Returns ``sp_plan``'s plan, also kept as
    ``model.sp_plan``. Runs before tp, DDP and FSDP2."""
    from transoar_tpu_torch.models.layers import InstanceNorm
    from transoar_tpu_torch.models.swin import SwinBlock
    from transoar_tpu_torch.ops.conv3d import Conv3d

    shard = layout.sp_shard
    encoder = model._backbone._encoder
    decoder = model._backbone._decoder
    plan = sp_plan(encoder.config, encoder.input_shape, shard.size)
    sharded = {s for s, kind in enumerate(plan) if kind == "sharded"}
    for s in sharded:
        for module in encoder._stages[s].modules():
            if isinstance(module, (Conv3d, InstanceNorm, SwinBlock)):
                module.sp = shard
    encoder.sp, encoder.gather_from = shard, len(sharded)
    decoder.sp, decoder.sharded = shard, frozenset(sharded)
    for s, out in zip(decoder.stages_needed, decoder._out):
        if s in sharded:
            out.sp = shard
    model.sp_plan = plan
    return plan
