"""3x3 band conv of the depth-packed stage-0 chain: CUDA kernel and its
plain version.

``packed_conv(xh, wp)`` is the port of the Pallas TPU kernel
``transoar_tpu/ops/pallas/packed_conv.py::_conv_rows`` (forward). It takes
flattened depth-packed rows ``xh [BD, H, W, Cin]`` and the block-banded
kernel ``wp [3, 3, Cin, Cout]`` (see ``ops/conv3d.py``) and returns
``[BD, H, W, Cout]``: a stride-1 3x3 conv over (H, W) with zero padding 1,
f32 accumulation, output in the input dtype.

- On a CUDA tensor it launches the hand-written kernel in
  ``csrc/packed_conv.cu`` (built with nvcc for sm_90a at first use) or
  raises; it never falls back.
- On a CPU tensor it runs ``packed_conv_reference``, the plain PyTorch
  version, which the CPU tests and the on-card check compare against.

The backward kernels (dx and the f32 dw reduction) come with training.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from transoar_tpu_torch.ops.kernels._build import load_library

_ENTRY = {torch.bfloat16: "packed_conv_fwd_bf16",
          torch.float32: "packed_conv_fwd_f32"}


def packed_conv_reference(xh: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """Plain version: NCHW ``F.conv2d`` with padding 1 in f32, cast back."""
    y = F.conv2d(xh.permute(0, 3, 1, 2).float(),
                 wp.permute(3, 2, 0, 1).float(), padding=1)
    return y.permute(0, 2, 3, 1).to(xh.dtype).contiguous()


@functools.cache
def _kernel(dtype: torch.dtype):
    fn = getattr(load_library("packed_conv"), _ENTRY[dtype])
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(xh: torch.Tensor, wp: torch.Tensor) -> None:
    if xh.dim() != 4 or wp.dim() != 4:
        raise ValueError(f"packed_conv wants xh [BD, H, W, Cin] and wp "
                         f"[3, 3, Cin, Cout], got {tuple(xh.shape)} and "
                         f"{tuple(wp.shape)}")
    if tuple(wp.shape[:3]) != (3, 3, xh.shape[-1]):
        raise ValueError(f"packed_conv: wp {tuple(wp.shape)} does not match "
                         f"xh {tuple(xh.shape)}")
    if xh.dtype not in _ENTRY or wp.dtype != xh.dtype:
        raise TypeError(f"packed_conv takes bf16 or f32 with matching types, "
                        f"got {xh.dtype} and {wp.dtype}")
    if xh.device != wp.device:
        raise ValueError(f"packed_conv: xh on {xh.device}, wp on {wp.device}")


def packed_conv(xh: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """3x3 (H, W) conv with torch-style padding on flattened packed rows."""
    _check(xh, wp)
    if xh.device.type == "cpu":
        return packed_conv_reference(xh, wp)
    if xh.device.type != "cuda":
        raise ValueError(f"packed_conv runs on cpu or cuda, not {xh.device}")
    if torch.is_grad_enabled() and (xh.requires_grad or wp.requires_grad):
        raise NotImplementedError("packed_conv backward: ROADMAP Queue 2")
    if not (xh.is_contiguous() and wp.is_contiguous()):
        raise ValueError("packed_conv wants contiguous xh and wp")
    BD, H, W, Cin = xh.shape
    Cout = wp.shape[-1]
    y = torch.empty((BD, H, W, Cout), dtype=xh.dtype, device=xh.device)
    if y.numel() == 0:
        return y
    fn = _kernel(xh.dtype)
    with torch.cuda.device(xh.device):
        err = fn(xh.data_ptr(), wp.data_ptr(), y.data_ptr(), BD, H, W, Cin,
                 Cout, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"packed_conv kernel launch failed: cudaError {err}")
    packed_conv.launches += 1
    return y


packed_conv.launches = 0
