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
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from transoar_tpu_torch.ops.conv3d import Conv3d, pack_depth, unpack_depth


def dropout(x: torch.Tensor, p: float,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Zero each element with probability ``p`` and scale the rest by
    1 / (1 - p) in x's dtype (flax ``nn.Dropout``); identity at p = 0."""
    if p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
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
    channel.
    """

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

    def forward(self, x: torch.Tensor, packs: int = 1) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1] // packs
        dims = tuple(range(1, x.dim() - 1))
        xf = x.float()
        mean = xf.mean(dims)
        mean2 = xf.square().mean(dims)
        del xf
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
    """``nn.Linear`` layout ([out, in] weight) computing in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, init: str = "lecun"):
        super().__init__()
        self.dtype = dtype
        self.init = init
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
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


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
    h = dropout(F.relu(linear1(x)), p, generator)
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
    the probabilities."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.dtype = dtype
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
        C = q.shape[-1]
        H, hd = self.num_heads, C // self.num_heads
        w = self.in_proj_weight.to(self.dtype)
        b = self.in_proj_bias.to(self.dtype)

        def proj(x, i):
            y = F.linear(x.to(self.dtype), w[i * C:(i + 1) * C],
                         b[i * C:(i + 1) * C])
            return y.unflatten(-1, (H, hd))

        qh, kh, vh = proj(q, 0), proj(k, 1), proj(v, 2)
        attn = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(hd)
        attn = attn.float().softmax(-1).to(self.dtype)
        attn = dropout(attn, self.dropout if self.training else 0.0,
                       generator)
        out = self.out_proj(torch.einsum("bhqk,bkhd->bqhd", attn,
                                         vh).flatten(-2))
        return (out, attn.float().mean(1)) if return_weights else out
