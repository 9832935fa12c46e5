"""3x3 stride-1 SAME conv over NHWC images on the packed band conv's CUDA
forward kernel.

``conv2d_3x3(x, w)`` is the port of the Pallas TPU kernel
``transoar_tpu/ops/pallas/conv2d.py::conv2d_3x3_pallas``: x ``[N, H, W, C]``
and w ``[3, 3, C, F]`` (cast to x's dtype, as the TPU side does) give
``[N, H, W, F]`` in x's dtype, with f32 accumulation and zero padding 1. It
is the same function as the forward of ``packed_conv`` (whose rows are
flattened depth-packed slices), so on a CUDA tensor it launches that
kernel (``csrc/packed_conv.cu``: bf16 on the tensor cores, the wide wgmma
variant where C % 8 == 0 and F is 64, 96 or 144, as at 64 -> 64; f32 on
the CUDA cores) or raises; on a CPU tensor it runs its plain version
``conv2d_3x3_reference``. Forward only, as on the TPU; its own launch count
is ``conv2d_3x3.launches``. No model path calls it.
"""

from __future__ import annotations

import torch

from transoar_tpu_torch.ops.kernels.packed_conv import (_launch_conv,
                                                        packed_conv_reference)


def conv2d_3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: w cast to x's dtype, then the band conv's plain
    version (NCHW ``F.conv2d`` with padding 1 in f32, cast to x's dtype)."""
    return packed_conv_reference(x, w.to(x.dtype))


def conv2d_3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [N, H, W, C], w [3, 3, C, F] -> [N, H, W, F]."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3,
                                                              x.shape[-1]):
        raise ValueError(f"conv2d_3x3 wants x [N, H, W, C] and w [3, 3, C, F]"
                         f", got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"conv2d_3x3: operands on {x.device} and {w.device}")
    if x.device.type == "cpu":
        return conv2d_3x3_reference(x, w)
    if x.device.type != "cuda" or x.dtype not in (torch.bfloat16,
                                                  torch.float32):
        raise TypeError(f"conv2d_3x3's kernel takes bf16 or f32 CUDA "
                        f"tensors, got {x.dtype} on {x.device}")
    y = _launch_conv(x.contiguous(), w.to(x.dtype).contiguous())
    conv2d_3x3.launches += 1
    return y


conv2d_3x3.launches = 0
