"""Shared building blocks, channels-last, f32 parameters, compute in ``dtype``.

Port of ``transoar_tpu/models/layers.py``. Each module casts its input and
its parameters to the compute dtype as the flax modules do (bf16 on the
serving path, f32 in the parity tests), so the two packages round at the
same places. Parameter names follow the reference torch ``state_dict``
(``_block.0.weight``, ``in_proj_weight``, ``linear1``...), which the weight
bridge (``utils/weights.py``) and ``transoar_tpu.utils.torch_import`` rely on.

Dropout (``dropout``) and stochastic depth (``drop_path``) draw their masks
from the ``torch.Generator`` passed to ``forward`` and apply only in
``train()`` mode, as flax's ``nn.Dropout`` with ``deterministic=False``.

Under tensor parallelism (``parallel/tp.py``) ``Linear``, the FFN and
``MultiHeadSelfAttention`` hold their tp rank's shard and call the tp
collectives; the head count of an attention is then the local one, the
projected width over the head dim. Dropout on a sharded activation draws
the mask of the whole tensor and keeps the rank's slice, so every tp rank
draws alike and keeps the masks one process would give those units.

Under spatial parallelism (``parallel/sp.py``) ``InstanceNorm`` on the
rank's block of S0 (its ``sp``) sums its statistics over the sp ranks.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from transoar_tpu_torch.ops.conv3d import Conv3d, pack_depth, unpack_depth
from transoar_tpu_torch.parallel import sp as sp_lib
from transoar_tpu_torch.parallel import tp as tp_lib


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator | None = None,
            shard=None) -> torch.Tensor:
    """Zero each element with probability ``p`` and scale the rest by
    1 / (1 - p) in x's dtype (flax ``nn.Dropout``); identity at p = 0.
    ``shard`` = (dim, full size, start): ``x`` is the slice
    [start, start + x.shape[dim]) of a tensor whose ``dim`` has the full
    size; the mask is drawn at the full size and sliced."""
    if p <= 0.0:
        return x
    if shard is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    else:
        dim, full, start = shard
        shape = list(x.shape)
        shape[dim] = full
        keep = (torch.rand(shape, generator=generator, device=x.device)
                >= p).narrow(dim, start, x.shape[dim])
    return torch.where(keep, x / (1.0 - p), 0.0)


def drop_path(x: torch.Tensor, p: float,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """Stochastic depth: zero whole samples with probability ``p`` (one draw
    per index of the first axis, broadcast over the others) and scale the
    rest by 1 / (1 - p), as flax ``nn.Dropout`` with ``broadcast_dims`` over
    every non-batch axis; identity at p = 0."""
    if p <= 0.0:
        return x
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    keep = torch.rand(shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def checkpoint_layer(layer: nn.Module, generator, *args):
    """``layer(*args, generator)`` under ``torch.utils.checkpoint``; the
    recompute draws from a generator reset to the state the forward
    started from, so it sees the forward's dropout masks, and
    ``generator`` ends where the forward left it."""
    if generator is None:
        return checkpoint(layer, *args, None, use_reentrant=False)
    start, end = generator.get_state(), []

    def run(*a):
        g = torch.Generator(device=generator.device)
        g.set_state(start)
        out = layer(*a, g)
        end.append(g.get_state())
        return out

    out = checkpoint(run, *args, use_reentrant=False)
    generator.set_state(end[0])
    return out


def _xavier_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                     generator: torch.Generator | None) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over the spatial axes of
    ``[B, *spatial, C]`` (torch ``InstanceNorm3d(affine=True, eps=1e-5)``).

    As in the JAX package: one-pass variance E[x^2] - E[x]^2 with statistics
    in f32, folded into one multiply-add in the compute dtype. With
    ``packs`` > 1 (depth-packed channels ``[..., packs*C]``) the statistics
    also aggregate across the pack blocks, which are depth slices of the same
    channel. With ``sp`` (the rank's equal block of S0) the two means are
    averaged over the sp ranks (one all-reduce), before the pack fold.
    """

    def __init__(self, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.sp = None
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, packs: int = 1) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1] // packs
        dims = tuple(range(1, x.dim() - 1))
        xf = x.float()
        mean = xf.mean(dims)
        mean2 = xf.square().mean(dims)
        del xf
        if self.sp is not None:
            mean, mean2 = (sp_lib.all_reduce(torch.stack([mean, mean2]),
                                             self.sp) / self.sp.size).unbind()
        if packs > 1:
            mean = mean.view(B, packs, C).mean(1)
            mean2 = mean2.view(B, packs, C).mean(1)
        inv = torch.rsqrt((mean2 - mean.square()).clamp_min(0.0) + self.eps)
        mul = (inv * self.weight).to(self.dtype)
        add = (self.bias - mean * inv * self.weight).to(self.dtype)
        shape = (B,) + (1,) * (x.dim() - 2) + (-1,)
        mul = mul.repeat(1, packs).view(shape)
        add = add.repeat(1, packs).view(shape)
        return x.to(self.dtype) * mul + add


class LayerNorm(nn.Module):
    """Last-axis LayerNorm (eps 1e-5) computed in f32, output in ``dtype``."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class Linear(nn.Module):
    """``nn.Linear`` layout ([out, in] weight) computing in ``dtype``.
    ``tp`` (set by ``parallel.tp.apply_tp``): column-parallel (the rank's
    output rows) or row-parallel (the rank's input columns; the partial
    sums all-reduced, then the bias)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, init: str = "lecun"):
        super().__init__()
        self.dtype = dtype
        self.init = init
        self.tp = None
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, generator=None):
        out_f, in_f = self.weight.shape
        if self.init == "xavier":
            _xavier_uniform_(self.weight, in_f, out_f, generator)
        elif self.init == "zeros":
            nn.init.zeros_(self.weight)
        else:
            with torch.no_grad():
                self.weight.normal_(0.0, 1.0 / math.sqrt(in_f),
                                    generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        w = self.weight.to(self.dtype)
        if self.tp is None:
            return F.linear(x.to(self.dtype), w, b)
        if self.tp.mode == "column":
            return F.linear(tp_lib.copy_to_tp(x.to(self.dtype), self.tp), w,
                            b)
        if x.shape[-1] != w.shape[1]:  # a replicated input: take the slice
            x = tp_lib.scatter_to_tp(x, self.tp)
        y = tp_lib.reduce_from_tp(F.linear(x.to(self.dtype), w), self.tp)
        return y if b is None else y + b

    def tp_slice(self):
        """(dim, full size, start) of a column-parallel output, for
        ``dropout``; None when the output is whole."""
        if self.tp is None or self.tp.mode != "column":
            return None
        n = self.weight.shape[0]
        return (-1, n * self.tp.size, n * self.tp.rank)


def conv_in_relu(conv: Conv3d, norm: InstanceNorm, x: torch.Tensor,
                 pack: int = 0) -> torch.Tensor:
    return F.relu(norm(conv(x, pack), packs=max(pack, 1)))


class ConvInReLU(nn.Sequential):
    """Conv3d (no bias) + InstanceNorm + ReLU; children 0, 1, 2 as in the
    reference's ``nn.Sequential`` encoder blocks.

    ``forward(x, pack)``: with ``pack`` > 0 the input and output are
    depth-packed and the conv runs the packed band kernel.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride=1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(
            Conv3d(in_channels, out_channels, kernel_size, stride, bias=False,
                   dtype=dtype),
            InstanceNorm(out_channels, dtype=dtype),
            nn.ReLU())

    def forward(self, x: torch.Tensor, pack: int = 0) -> torch.Tensor:
        return conv_in_relu(self[0], self[1], x, pack)


class EncoderCnnBlock(nn.Module):
    """One backbone stage: strided Conv-IN-ReLU, then unit-stride
    Conv-IN-ReLU, as ``_block.{0..5}`` (reference encoder_blocks.py:28-54).

    With ``pack`` > 0 on a stride-1, kernel-3 stage whose depth divides by
    ``pack``, both convs (and their norms) run in the depth-packed layout:
    one pack before the first conv and one unpack after the second.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride=(1, 1, 1), pack: int = 0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stride = tuple(stride)
        self.kernel_size = kernel_size
        self.pack = pack
        self.dtype = dtype
        self._block = nn.Sequential(
            *ConvInReLU(in_channels, out_channels, kernel_size, self.stride,
                        dtype),
            *ConvInReLU(out_channels, out_channels, kernel_size, 1, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pack = self.pack if (self.pack and self.stride == (1, 1, 1)
                             and self.kernel_size == 3
                             and x.shape[1] % self.pack == 0) else 0
        b = self._block
        if pack:
            x = pack_depth(x.to(self.dtype), pack)
        x = conv_in_relu(b[0], b[1], x, pack)
        x = conv_in_relu(b[3], b[4], x, pack)
        return unpack_depth(x, pack) if pack else x


class MLP(nn.Module):
    """ReLU MLP head, ``layers.{i}`` (reference transoarnet.py:157-171)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, dtype: torch.dtype = torch.bfloat16,
                 zero_init_last: bool = False):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], dtype=dtype,
                   init="zeros" if zero_init_last and i == num_layers - 1
                   else "lecun")
            for i in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def feed_forward(x: torch.Tensor, linear1: Linear, linear2: Linear,
                 norm: LayerNorm, p: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Transformer FFN with residual and post-LayerNorm; dropout ``p`` after
    the activation and after the second projection."""
    h = dropout(F.relu(linear1(x)), p, generator, linear1.tp_slice())
    return norm(x + dropout(linear2(h), p, generator))


class FFN(nn.Module):
    """Feed-forward block (reference focused_decoder.py:165-169)."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dropout = dropout
        self.linear1 = Linear(d_model, dim_feedforward, dtype=dtype,
                              init="xavier")
        self.linear2 = Linear(dim_feedforward, d_model, dtype=dtype,
                              init="xavier")
        self.norm = LayerNorm(d_model, dtype=dtype)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return feed_forward(x, self.linear1, self.linear2, self.norm,
                            self.dropout if self.training else 0.0, generator)


class MultiHeadSelfAttention(nn.Module):
    """``nn.MultiheadAttention`` parameters (packed ``in_proj_weight``
    [3C, C], ``in_proj_bias``, ``out_proj``); softmax in f32, dropout on
    the probabilities. Under ``tp`` the packed projection holds the rank's
    heads' rows of each of q, k and v ([3C / tp, C]) and ``out_proj`` is
    row-parallel."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.dropout = dropout
        self.dtype = dtype
        self.tp = None
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model))
        self.out_proj = Linear(d_model, d_model, dtype=dtype, init="xavier")

    def reset_parameters(self, generator=None):
        C = self.in_proj_weight.shape[1]
        for i in range(3):  # xavier per projection, as the flax q/k/v kernels
            _xavier_uniform_(self.in_proj_weight[i * C:(i + 1) * C], C, C,
                             generator)
        nn.init.zeros_(self.in_proj_bias)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                generator: torch.Generator | None = None,
                return_weights: bool = False):
        """The output, or (output, head-averaged f32 weights [B, Q, K]) with
        ``return_weights``, torch ``MultiheadAttention``'s convention."""
        w = self.in_proj_weight.to(self.dtype)
        b = self.in_proj_bias.to(self.dtype)
        C = w.shape[0] // 3  # the local width under tp
        hd = self.head_dim
        H = C // hd

        def proj(x, i):
            x = x.to(self.dtype)
            if self.tp is not None:
                x = tp_lib.copy_to_tp(x, self.tp)
            y = F.linear(x, w[i * C:(i + 1) * C], b[i * C:(i + 1) * C])
            return y.unflatten(-1, (H, hd))

        qh, kh, vh = proj(q, 0), proj(k, 1), proj(v, 2)
        attn = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(hd)
        attn = attn.float().softmax(-1).to(self.dtype)
        shard = None if self.tp is None else (1, self.num_heads,
                                              self.tp.rank * H)
        attn = dropout(attn, self.dropout if self.training else 0.0,
                       generator, shard)
        out = self.out_proj(torch.einsum("bhqk,bkhd->bqhd", attn,
                                         vh).flatten(-2))
        return (out, attn.float().mean(1)) if return_weights else out
