"""3D convolutions of the serving path, channels-last at the boundaries.

Port of the parts of ``transoar_tpu/ops/conv3d.py`` that the flagship path
runs:

- ``Conv3d``: torch-style symmetric padding ``(k - 1) // 2``, kernel 1 or 3,
  stride 1 or 2 — stock ``F.conv3d``. Activations stay ``[B, S0, S1, S2, C]``
  as in the JAX package; ``x.permute(0, 4, 1, 2, 3)`` is a
  ``channels_last_3d`` view that cuDNN takes without a copy. With ``pack`` set
  the layer runs the depth-packed chain instead (below).
- ``ConvTranspose3d``: the kernel == stride up-conv of the FPN
  (``FastConvTranspose3D``) — stock ``F.conv_transpose3d``.
- The depth-packed stage-0 chain (``pack_depth``, ``unpack_depth``,
  ``_packed_band_kernel``, ``conv3d_packed_chain``): ``pack`` consecutive
  depth slices fold into channels and each KD=3 conv becomes one 3x3 band
  conv, which runs the hand-written kernel ``ops/kernels/packed_conv.py``.

Under spatial parallelism (``parallel/sp.py``; a layer's ``sp``, set by
``apply_sp``) the input is the rank's block of S0. A conv takes a halo of
its neighbours' rows over S0 and no padding there: kernel 3, stride 1 a row
on each side; kernel 3, stride 2 a row below (the local extent even);
kernel 1 and the kernel 2, stride 2 merge none. The packed chain takes the
neighbours' edge packed rows where one process takes zeros, so kernels 1-3
run unchanged on the rank's rows. The transposed conv (kernel == stride)
is local.

Parameters are f32 and named and shaped as torch's ``nn.Conv3d`` /
``nn.ConvTranspose3d``; compute runs in the layer's ``dtype``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from transoar_tpu_torch.ops.kernels.packed_conv import packed_conv
from transoar_tpu_torch.parallel import sp as sp_lib


def pack_depth(x: torch.Tensor, pack: int) -> torch.Tensor:
    """[B, D, H, W, C] -> [B, D/pack, H, W, pack*C]; depth offset g within a
    pack occupies channels [g*C, (g+1)*C)."""
    B, D, H, W, C = x.shape
    if D % pack:
        raise ValueError(f"depth {D} is not a multiple of pack {pack}")
    xp = x.reshape(B, D // pack, pack, H, W, C)
    return xp.movedim(2, 4).reshape(B, D // pack, H, W, pack * C)


def unpack_depth(xp: torch.Tensor, pack: int) -> torch.Tensor:
    """Inverse of ``pack_depth``."""
    B, Dp, H, W, PC = xp.shape
    x = xp.reshape(B, Dp, H, W, pack, PC // pack)
    return x.movedim(4, 2).reshape(B, Dp * pack, H, W, PC // pack)


def _packed_band_kernel(w: torch.Tensor, pack: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """Block-banded 2D kernel [KH, KW, (pack+2)*C, pack*F] from a KD=3 kernel
    w [KD, KH, KW, C, F]: output depth block g draws tap kd from input halo
    block g + kd (input layout [last C of prev | pack*C | first C of next])."""
    KD, KH, KW, C, Fo = w.shape
    wp = torch.zeros((KH, KW, (pack + 2) * C, pack * Fo), dtype=dtype,
                     device=w.device)
    for g in range(pack):
        for kd in range(KD):
            j = g + kd
            wp[:, :, j * C:(j + 1) * C, g * Fo:(g + 1) * Fo] = w[kd].to(dtype)
    return wp


def _shift_back(t: torch.Tensor, sp=None) -> torch.Tensor:
    """t'[j] = t[j-1] along axis 1 (zero at j=0 of the volume; under ``sp``
    the previous rank's last row at the block's j=0)."""
    if sp is not None:
        return sp_lib.halo(t, 1, 0, sp)[:, :-1]
    return torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)


def _shift_fwd(t: torch.Tensor, sp=None) -> torch.Tensor:
    """t'[j] = t[j+1] along axis 1 (zero at the volume's last j; under
    ``sp`` the next rank's first row at the block's last j)."""
    if sp is not None:
        return sp_lib.halo(t, 0, 1, sp)[:, 1:]
    return torch.cat([t[:, 1:], torch.zeros_like(t[:, :1])], dim=1)


def conv3d_packed_chain(xp: torch.Tensor, w: torch.Tensor,
                        pack: int, sp=None) -> torch.Tensor:
    """Stride-1 KD=3 conv on packed input [B, Dp, H, W, pack*C] with kernel
    w [3, KH, KW, C, F]; output packed [B, Dp, H, W, pack*F].

    The depth halo (one slice each side of a pack) is rebuilt from the packed
    layout: the last C channels of row q-1 and the first C of row q+1, zero at
    both ends of the volume (under ``sp``, the rank's block of rows: the
    neighbours' rows at its interior ends). Torch-style symmetric padding.
    """
    B, Dp, H, W, PC = xp.shape
    KD, KH, KW, C, Fo = w.shape
    if PC != pack * C or (KD, KH, KW) != (3, 3, 3):
        raise ValueError(f"packed chain: input {tuple(xp.shape)}, kernel "
                         f"{tuple(w.shape)}, pack {pack}")
    prev = _shift_back(xp[..., (pack - 1) * C:], sp)   # x[pack*q - 1]
    nxt = _shift_fwd(xp[..., :C], sp)                  # x[pack*(q+1)]
    xh = torch.cat([prev, xp, nxt], dim=-1)
    wp = _packed_band_kernel(w, pack, xp.dtype)
    y = packed_conv(xh.reshape(B * Dp, H, W, (pack + 2) * C), wp)
    return y.reshape(B, Dp, H, W, pack * Fo)


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: torch.Generator | None) -> None:
    with torch.no_grad():
        t.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)


class Conv3d(nn.Module):
    """Channels-last 3D conv with torch-style symmetric padding.

    ``forward(x, pack=0)``: with ``pack`` > 0 (kernel 3, stride 1 only) the
    input and output are depth-packed and the conv runs
    ``conv3d_packed_chain``. ``sp``: the rank's block of S0 with halos
    (module docstring).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride=1, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        k = kernel_size
        self.stride = (stride,) * 3 if isinstance(stride, int) \
            else tuple(stride)
        self.kernel_size = k
        self.padding = (k - 1) // 2
        self.dtype = dtype
        self.sp = None
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               k, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator=None):
        _lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, pack: int = 0) -> torch.Tensor:
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        if pack:
            if self.stride != (1, 1, 1):
                raise ValueError("the packed chain runs stride-1 convs only")
            # [F, C, kd, kh, kw] -> [kd, kh, kw, C, F]
            out = conv3d_packed_chain(x, w.permute(2, 3, 4, 1, 0), pack,
                                      self.sp)
            if self.bias is not None:
                out = out + self.bias.to(self.dtype).repeat(pack)
            return out
        b = None if self.bias is None else self.bias.to(self.dtype)
        p = self.padding
        padding = p
        if self.sp is not None:
            # rows of the neighbours in place of the padding over S0: p
            # below, and above what the last output's window reaches past
            # the block (a multiple of the stride, ``sp_plan``)
            hi = max(self.kernel_size - p - self.stride[0], 0)
            if p or hi:
                x = sp_lib.halo(x, p, hi, self.sp)
            padding = (0, p, p)
        out = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, self.stride,
                       padding)
        return out.permute(0, 2, 3, 4, 1)


class ConvTranspose3d(nn.Module):
    """Channels-last transposed conv with kernel == stride (FPN up-path)."""

    def __init__(self, in_channels: int, out_channels: int, stride,
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stride = tuple(stride)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels,
                                               *self.stride))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator=None):
        fan_in = self.weight.shape[0] * math.prod(self.stride)
        _lecun_normal_(self.weight, fan_in, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        out = F.conv_transpose3d(x.to(self.dtype).permute(0, 4, 1, 2, 3),
                                 self.weight.to(self.dtype), b, self.stride)
        return out.permute(0, 2, 3, 4, 1)
