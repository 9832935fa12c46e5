"""Tensor parallelism over the mesh's ``tp`` axis: Megatron by hand (port of
``transoar_tpu/parallel/tp.py``).

The JAX package annotates the neck's parameters with ``NamedSharding``s
and lets GSPMD insert the collectives. Here each tp rank holds only its
shard of those parameters as a plain tensor, and the sharded modules call
the two collectives themselves:

- column-parallel (the attention's q, k and v projections, the FFN's
  ``linear1``): the replicated input passes ``copy_to_tp`` (identity
  forward, all-reduce of the gradient backward), the rank computes its
  heads or hidden units;
- row-parallel (the attention's ``proj`` / ``out_proj``, the FFN's
  ``linear2``): the rank multiplies its slice of the contraction, the
  partial sums pass ``reduce_from_tp`` (all-reduce forward, identity
  backward), then the replicated bias is added once. A row-parallel layer
  whose input is replicated (heads that do not divide while the width
  does) first takes its slice of the input (``scatter_to_tp``: slice
  forward, all-gather backward).

Replicated parameters therefore get the whole gradient on every tp rank
and sharded ones the shard of it, with no further reduction; DDP or FSDP2
average over dp on top (``parallel/fsdp.py``). The custom kernels of the
backbone see plain local tensors: the backbone stays replicated.

``tp_plan`` is the JAX ``param_pspec`` rule keyed on the port's names:

- ``self_attn`` / ``cross_attn`` (the port's DETR cross-attention holds
  the JAX ``mha`` directly): q, k, v over heads (torch ``[out, in]``
  weights on dim 0, their biases too; the packed ``in_proj_weight`` [3C, C]
  per chunk: each rank holds its heads' rows of q, of k and of v), ``proj``
  / ``out_proj`` weights on dim 1, their biases replicated;
- the FFN (``ffn.linear1/2``; the Focused Decoder layer's own ``linear1/2``,
  which are the JAX ``ffn``): ``linear1`` weight and bias on dim 0,
  ``linear2`` weight on dim 1;
- a leaf whose dim does not divide stays replicated (``_divides``; the
  head count for q, k, v);
- everything else is replicated: the backbone, Swin, MSDeformAttn's
  ``value_proj`` / ``output_proj``, the refine block, the heads.

State dicts keep the unsharded layout: ``gather_state`` reassembles the
shards, ``shard_state`` cuts a full tensor for a rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn

_ATTN = ("self_attn", "cross_attn")
_COLUMN_PROJ = ("q_proj", "k_proj", "v_proj")
_ROW_PROJ = ("proj", "out_proj")


class TPShard:
    """What a sharded module needs to know: the tp group, this rank's index
    in it, the group's size, the module's mode (``"column"``: its output
    rows, the packed attention's included; ``"row"``: its input columns)
    and the names of its parameters that are shards (``params``)."""

    def __init__(self, group, rank, size, mode):
        self.group, self.rank, self.size, self.mode = group, rank, size, mode
        self.params = set()


class _CopyToTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ScatterToTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        n = x.shape[-1] // shard.size
        return x.narrow(-1, shard.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        parts = [torch.empty_like(grad) for _ in range(shard.size)]
        dist.all_gather(parts, grad.contiguous(), group=shard.group)
        return torch.cat(parts, -1), None


def copy_to_tp(x, shard):
    return _CopyToTP.apply(x, shard.group)


def reduce_from_tp(x, shard):
    return _ReduceFromTP.apply(x, shard.group)


def scatter_to_tp(x, shard):
    return _ScatterToTP.apply(x, shard)


def _heads(model, name):
    module = model.get_submodule(name) if name else model
    return getattr(module, "num_heads", None)


def tp_rule(name, shape, tp, heads=None):
    """(dim, chunks) of the torch parameter ``name`` of ``shape`` split over
    ``tp`` ranks, or None where it stays replicated. ``heads``: the owning
    attention's head count (q, k, v divide by heads). ``chunks`` = 3 for the
    packed ``in_proj_*``: each of its three chunks is split on its own."""
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    grand = parts[-3] if len(parts) >= 3 else ""

    def divides(n):
        return n is not None and n % tp == 0

    if parent in _ATTN and leaf in ("in_proj_weight", "in_proj_bias"):
        return (0, 3) if divides(heads) else None
    if grand in _ATTN:
        if parent in _COLUMN_PROJ and leaf in ("weight", "bias"):
            return (0, 1) if divides(heads) else None
        if parent in _ROW_PROJ and leaf == "weight" and len(shape) == 2:
            return (1, 1) if divides(shape[1]) else None
        return None
    if parent in ("linear1", "linear2") and (grand == "ffn"
                                             or parts[0] == "_neck"):
        if parent == "linear1" and leaf in ("weight", "bias"):
            return (0, 1) if divides(shape[0]) else None
        if parent == "linear2" and leaf == "weight" and len(shape) == 2:
            return (1, 1) if divides(shape[1]) else None
    return None


def tp_plan(model, tp):
    """{parameter name: (dim, chunks)} of every parameter of the unwrapped
    ``model`` that ``tp_rule`` shards over ``tp`` ranks. At ``tp`` = 1 every
    leaf of the rule is planned (one shard each): ``apply_tp`` then runs the
    sharded modules' code over a one-rank group."""
    plan = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        owner = ".".join(parts[:-1] if parts[-1].startswith("in_proj")
                         else parts[:-2])
        rule = tp_rule(name, tuple(p.shape), tp, _heads(model, owner))
        if rule is not None:
            plan[name] = rule
    return plan


def shard_tensor(full, dim, chunks, rank, size):
    """Rank ``rank``'s shard of ``full``: each of its ``chunks`` equal
    chunks along ``dim`` split in ``size`` and the rank's piece of each
    kept, in order."""
    n = full.shape[dim] // chunks // size
    return full.unflatten(dim, (chunks, -1)).narrow(
        dim + 1, rank * n, n).flatten(dim, dim + 1)


def unshard_tensors(shards, dim, chunks):
    """``shard_tensor``'s inverse over the ranks' shards, in rank order."""
    return torch.cat([s.unflatten(dim, (chunks, -1)) for s in shards],
                     dim + 1).flatten(dim, dim + 1)


def apply_tp(model, group, rank, size):
    """Cut the parameters ``tp_plan`` names to this rank's shards and set
    the owning modules' ``tp`` (a ``TPShard``); returns the plan, also kept
    as ``model.tp_plan``. Runs before DDP / FSDP2 wrap the model."""
    plan = tp_plan(model, size)
    for name, (dim, chunks) in plan.items():
        owner, leaf = name.rsplit(".", 1)
        module = model.get_submodule(owner)
        p = getattr(module, leaf)
        local = shard_tensor(p.detach(), dim, chunks, rank, size)
        setattr(module, leaf, nn.Parameter(local.clone(),
                                           requires_grad=p.requires_grad))
        if module.tp is None:
            module.tp = TPShard(group, rank, size,
                                "column" if dim == 0 else "row")
        module.tp.params.add(leaf)
    model.tp_plan = plan
    return plan


def gather_tensor(local, rule, group, size):
    """The whole tensor of the tp ranks' shards ``local`` (collective over
    the tp group)."""
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(parts, local, group=group)
    return unshard_tensors(parts, *rule)


def gather_state(state, plan, group, size):
    """A state dict (parameter name -> tensor) with every planned tensor
    reassembled from the tp ranks' shards (collective over the tp
    group)."""
    return {name: gather_tensor(v, plan[name], group, size)
            if name in plan else v for name, v in state.items()}


def shard_state(state, plan, rank, size):
    """A full state dict cut to rank ``rank``'s shards."""
    out = dict(state)
    for name, (dim, chunks) in plan.items():
        out[name] = shard_tensor(state[name], dim, chunks, rank, size)
    return out


def tp_sharded(model):
    """[whether each parameter of ``model.parameters()`` is a tp shard], in
    order, read from the modules' ``tp`` (FSDP2 replaces the parameter
    objects, not the modules)."""
    flags = {}
    for module in model.modules():
        shard = getattr(module, "tp", None)
        for name, p in module.named_parameters(recurse=False):
            flags[id(p)] = shard is not None and name in shard.params
    return [flags[id(p)] for p in model.parameters()]
