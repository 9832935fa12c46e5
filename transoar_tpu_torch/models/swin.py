"""3D Swin Transformer encoder stages (SwinFPN), channels-last.

Port of ``transoar_tpu/models/swin.py`` (reference ``transoar/models/
backbones/encoder_blocks.py:56-400``), flat-window path only:

- ``WindowAttention3D``: qkv projection, the relative-position bias table
  ``[(2w0-1)(2w1-1)(2w2-1), H]`` gathered by the relative index, the fused
  window attention kernel (``ops/kernels/window_attention.py``), ``proj``.
- ``SwinBlock``: LayerNorm, pad to the window, cyclic shift
  (``torch.roll``), window attention, un-shift, crop, DropPath on both
  residual branches, LayerNorm, MLP with exact-erf GELU.
- ``PatchMerging``: the 2x2x2 neighbourhood concat in the channel-block
  order the reference weights depend on, LayerNorm, Linear to 2C;
  ``ConvPatchMerging`` (``swin.conv_merging``) a 2x2x2 stride-2 conv,
  InstanceNorm and ReLU (``downsample.conv``, ``downsample.norm``).
- ``EncoderSwinBlock``: one encoder stage, ``depth`` blocks alternating
  unshifted and shifted windows, then the merge.

The numpy helpers (``effective_window``, ``window_partition``,
``window_reverse``, ``relative_position_index``, ``shifted_window_regions``)
are copies of the JAX package's, pinned by ``tests/test_torch_copies.py``;
the partition functions work on numpy arrays and torch tensors alike. The
region labels and the relative index are built once per static shape and
kept on the device. Parameter names follow the reference ``state_dict``
(``blocks.{j}.norm1``, ``attn.relative_position_bias_table``, ``attn.qkv``,
``attn.proj``, ``mlp.fc1``, ``mlp.fc2``, ``downsample.norm``,
``downsample.reduction``).

Under spatial parallelism (``parallel/sp.py``) a sharded stage's blocks
(their ``sp``) hold the rank's block of S0, a whole number of windows
(``sp_plan``): the window is clamped on the global extent, the cyclic
shift over S0 is ``sp.roll``, the region labels are the global ones at
the rank's windows, and S0 needs no end pad. The merge is local on the
block's even extent.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from transoar_tpu_torch.models.layers import (InstanceNorm, LayerNorm,
                                              Linear, drop_path)
from transoar_tpu_torch.ops.conv3d import Conv3d
from transoar_tpu_torch.ops.kernels.window_attention import \
    fused_window_attention
from transoar_tpu_torch.parallel import sp as sp_lib


def effective_window(spatial, window_size, shift_size):
    """Clamp window to the volume size; no shift along collapsed axes
    (reference get_window_size, encoder_blocks.py:371-384)."""
    ws, ss = list(window_size), list(shift_size)
    for i, s in enumerate(spatial):
        if s <= window_size[i]:
            ws[i] = s
            ss[i] = 0
    return tuple(ws), tuple(ss)


def window_partition(x, ws):
    """[B, D, H, W, C] -> [B*nW, ws0*ws1*ws2, C]
    (encoder_blocks.py:360-364)."""
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2], ws[2],
                  C)
    x = x.transpose(0, 1, 3, 5, 2, 4, 6, 7) if isinstance(x, np.ndarray) \
        else x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, ws[0] * ws[1] * ws[2], C)


def window_reverse(windows, ws, B, D, H, W):
    x = windows.reshape(B, D // ws[0], H // ws[1], W // ws[2], ws[0], ws[1],
                        ws[2], -1)
    x = x.transpose(0, 1, 4, 2, 5, 3, 6, 7) if isinstance(x, np.ndarray) \
        else x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, -1)


def relative_position_index(ws) -> np.ndarray:
    """[N, N] indices into the (2w0-1)(2w1-1)(2w2-1) bias table
    (encoder_blocks.py:234-248)."""
    coords = np.stack(np.meshgrid(np.arange(ws[0]), np.arange(ws[1]),
                                  np.arange(ws[2]), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [3, N, N]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws[0] - 1
    rel[:, :, 1] += ws[1] - 1
    rel[:, :, 2] += ws[2] - 1
    rel[:, :, 0] *= (2 * ws[1] - 1) * (2 * ws[2] - 1)
    rel[:, :, 1] *= 2 * ws[2] - 1
    return rel.sum(-1)


def shifted_window_regions(padded_shape, ws, ss) -> np.ndarray:
    """[nW, N] per-token region labels of the cyclic shift: two tokens may
    attend iff their labels match (encoder_blocks.py:387-400)."""
    Dp, Hp, Wp = padded_shape

    def axis_regions(ws_i, ss_i):
        # a zero-shift axis is ONE region spanning everything
        if ss_i == 0:
            return (slice(None),)
        return (slice(-ws_i), slice(-ws_i, -ss_i), slice(-ss_i, None))

    img = np.zeros((1, Dp, Hp, Wp, 1), np.float32)
    cnt = 0
    for d in axis_regions(ws[0], ss[0]):
        for h in axis_regions(ws[1], ss[1]):
            for w in axis_regions(ws[2], ss[2]):
                img[:, d, h, w, :] = cnt
                cnt += 1
    return window_partition(img, ws)[..., 0].astype(np.float32)


def _constant(array: np.ndarray, device: torch.device) -> torch.Tensor:
    # a cached constant first built under inference_mode must stay usable
    # by autograd later
    with torch.inference_mode(False):
        return torch.as_tensor(array, device=device)


@functools.lru_cache(maxsize=None)
def _regions(padded_shape, ws, ss, device: torch.device,
             part=(0, 1)) -> torch.Tensor:
    """Region labels on the device: [nW, N] when shifted, else one zero row
    [1, N] (nothing masked). ``part`` = (rank, ranks): the rank's equal
    share of the windows, which are S0-major."""
    if any(ss):
        labels = shifted_window_regions(padded_shape, ws, ss)
        n = len(labels) // part[1]
        labels = labels[part[0] * n:(part[0] + 1) * n]
    else:
        labels = np.zeros((1, int(np.prod(ws))), np.float32)
    return _constant(labels, device)


@functools.lru_cache(maxsize=None)
def _rel_index(ws, device: torch.device) -> torch.Tensor:
    return _constant(relative_position_index(ws).reshape(-1).astype(np.int64),
                     device)


class WindowAttention3D(nn.Module):
    """Window-local multi-head attention with a learned 3D relative-position
    bias, over flat windows ``[B_, N, C]``."""

    def __init__(self, dim: int, window_size: Sequence[int], num_heads: int,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        w0, w1, w2 = window_size
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            (2 * w0 - 1) * (2 * w1 - 1) * (2 * w2 - 1), num_heads))
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            t = self.relative_position_bias_table
            t.copy_(torch.nn.init.trunc_normal_(
                torch.empty(t.shape), std=0.02, a=-0.04, b=0.04,
                generator=generator))

    def bias(self, ws) -> torch.Tensor:
        """f32 [H, N, N] of the (possibly clamped) window ``ws``."""
        N = int(np.prod(ws))
        table = self.relative_position_bias_table
        idx = _rel_index(tuple(ws), table.device)
        return table[idx].view(N, N, self.num_heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, ws, regions: torch.Tensor
                ) -> torch.Tensor:
        """x [B_, N, C] windows of shape ``ws``; regions [nW, N] labels."""
        B_, N, C = x.shape
        H = self.num_heads
        hd = C // H
        # q, k, v stay views of the projection's [B_, N, 3, H, hd] output
        # (q is scaled into a new tensor); the kernel reads them strided
        qkv = self.qkv(x).view(B_, N, 3, H, hd)
        q = (qkv[:, :, 0] * hd ** -0.5).transpose(1, 2)
        k = qkv[:, :, 1].transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        out = fused_window_attention(q, k, v, self.bias(ws), regions)
        return self.proj(out.transpose(1, 2).reshape(B_, N, C))


class Mlp(nn.Module):
    """fc1 -> exact-erf GELU -> fc2 (reference ``mlp.fc1``, ``mlp.fc2``)."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """LN -> (shifted-)window attention -> residual, LN -> MLP -> residual,
    with DropPath ``drop_path`` on both branches in ``train()`` mode."""

    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int],
                 shift: bool, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 spatial: Sequence[int] | None = None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift = shift
        self.drop_path = float(drop_path)
        self.sp = None
        self.norm1 = LayerNorm(dim, dtype=dtype)
        # the bias table has the size of the window clamped to the input
        # volume ``spatial`` (the JAX module is built for the window it
        # runs; the reference torch module keeps the configured size)
        self.attn_window = self.window_size if spatial is None else \
            effective_window(spatial, self.window_size, (0, 0, 0))[0]
        self.attn = WindowAttention3D(dim, self.attn_window, num_heads,
                                      qkv_bias, dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def _roll(self, x: torch.Tensor, shifts) -> torch.Tensor:
        if self.sp is None:
            return torch.roll(x, shifts=tuple(shifts), dims=(1, 2, 3))
        x = sp_lib.roll(x, shifts[0], self.sp)
        return torch.roll(x, shifts=tuple(shifts[1:]), dims=(2, 3))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x [B, D, H, W, C] (under ``sp`` the rank's block of D); DropPath
        masks come from ``generator``."""
        B, D, H, W, C = x.shape
        ranks = 1 if self.sp is None else self.sp.size
        ws, ss = effective_window(
            (D * ranks, H, W), self.window_size,
            tuple(w // 2 for w in self.window_size) if self.shift
            else (0, 0, 0))
        if ws != self.attn_window:
            raise ValueError(f"this block was built for a {self.attn_window}"
                             f" window; a {(D * ranks, H, W)} input gives "
                             f"{ws}")
        rate = self.drop_path if self.training else 0.0

        shortcut = x
        x = self.norm1(x)
        # under sp the block holds whole windows over S0 (``sp_plan``)
        pad = [(ws[i] - x.shape[1 + i] % ws[i]) % ws[i] for i in range(3)]
        x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        Dp, Hp, Wp = x.shape[1:4]
        if any(ss):
            x = self._roll(x, [-s for s in ss])
        part = (0, 1) if self.sp is None else (self.sp.rank, ranks)
        regions = _regions((Dp * ranks, Hp, Wp), ws, ss, x.device, part)
        x = self.attn(window_partition(x, ws), ws, regions)
        x = window_reverse(x, ws, B, Dp, Hp, Wp)
        if any(ss):
            x = self._roll(x, ss)
        x = shortcut + drop_path(x[:, :D, :H, :W], rate, generator)
        return x + drop_path(self.mlp(self.norm2(x)), rate, generator)


class PatchMerging(nn.Module):
    """2x2x2 -> 8C concat -> LN -> Linear(2C) (encoder_blocks.py:305-334)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.norm = LayerNorm(8 * dim, dtype=dtype)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, D, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2, 0, D % 2))
        D2, H2, W2 = x.shape[1] // 2, x.shape[2] // 2, x.shape[3] // 2
        # channel blocks in the reference's x0..x7 order: d outer, then w,
        # then h (block (d, w, h) = x[:, d::2, h::2, w::2])
        x = x.reshape(B, D2, 2, H2, 2, W2, 2, C)
        x = x.permute(0, 1, 3, 5, 2, 6, 4, 7).reshape(B, D2, H2, W2, 8 * C)
        return self.reduction(self.norm(x))


class ConvPatchMerging(nn.Module):
    """``swin.conv_merging``: a 2x2x2 stride-2 conv without bias, then
    InstanceNorm and ReLU (JAX ``ConvPatchMerging``, swin.py:391-402),
    children ``conv`` and ``norm``. Every spatial size must be even, as the
    JAX patch matmul asserts."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = Conv3d(dim, 2 * dim, 2, stride=2, bias=False, dtype=dtype)
        self.norm = InstanceNorm(2 * dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if any(n % 2 for n in x.shape[1:4]):
            raise ValueError(f"conv merging needs even sizes, got "
                             f"{tuple(x.shape[1:4])}")
        return F.relu(self.norm(self.conv(x)))


class EncoderSwinBlock(nn.Module):
    """One encoder stage: ``depth`` SwinBlocks at the incoming channel count
    (odd blocks shifted), then patch merging (downsample x2, channels x2).
    ``spatial`` is the stage's input volume (D, H, W), which sizes the bias
    tables; None keeps the configured window."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: Sequence[int], mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path: Sequence[float] = (),
                 conv_merging: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 spatial: Sequence[int] | None = None):
        super().__init__()
        rates = list(drop_path) + [0.0] * depth
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, shift=i % 2 == 1,
                      mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                      drop_path=rates[i], dtype=dtype, spatial=spatial)
            for i in range(depth))
        self.downsample = (ConvPatchMerging if conv_merging
                           else PatchMerging)(dim, dtype)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, generator)
        return self.downsample(x)
