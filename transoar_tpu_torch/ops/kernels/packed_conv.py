"""3x3 band conv of the depth-packed stage-0 chain: CUDA kernels and their
plain versions.

``packed_conv(xh, wp)`` is the port of the Pallas TPU kernel
``transoar_tpu/ops/pallas/packed_conv.py::packed_conv``. It takes
flattened depth-packed rows ``xh [BD, H, W, Cin]`` and the block-banded
kernel ``wp [3, 3, Cin, Cout]`` (see ``ops/conv3d.py``) and returns
``[BD, H, W, Cout]``: a stride-1 3x3 conv over (H, W) with zero padding 1,
f32 accumulation, output in the input dtype. Where autograd needs it, the
call goes through ``_PackedConv``, whose backward mirrors
``_packed_conv_bwd``:

- ``packed_conv_dx(dy, wp)``: the forward kernel on ``dy`` with ``wp``
  flipped over (kh, kw) and transposed over (in, out), as the TPU side does;
- ``packed_conv_dw(xh, dy)``: the f32 ``[3, 3, Cin, Cout]`` weight gradient
  (the port of ``_dw_rows``), a split reduction with no atomics, so it is
  deterministic; the backward casts it to ``wp``'s dtype.

Each of the three, on a CUDA tensor, launches its hand-written kernel in
``csrc/packed_conv.cu`` (built with nvcc for sm_90a at first use) or raises;
it never falls back. On a CPU tensor it runs its plain PyTorch version
(``packed_conv_reference``, ``packed_conv_dx_reference``,
``packed_conv_dw_reference``), which the CPU tests and the on-card checks
compare against; the CPU also takes f64, for ``gradcheck``. Each wrapper
counts its own launches (``packed_conv.launches``,
``packed_conv_dx.launches``, ``packed_conv_dw.launches``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from transoar_tpu_torch.ops.kernels._build import load_library

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """f32, or f64 for f64 inputs (the CPU's gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def packed_conv_reference(xh: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """Plain version: NCHW ``F.conv2d`` with padding 1 in f32, cast back."""
    acc = _acc_dtype(xh)
    y = F.conv2d(xh.permute(0, 3, 1, 2).to(acc),
                 wp.permute(3, 2, 0, 1).to(acc), padding=1)
    return y.permute(0, 2, 3, 1).to(xh.dtype).contiguous()


def packed_conv_dx_reference(dy: torch.Tensor,
                             wp: torch.Tensor) -> torch.Tensor:
    """Plain dx: ``F.conv_transpose2d`` of dy with the unflipped band in
    f32, cast to dy's dtype (independent of the kernel's flip)."""
    acc = _acc_dtype(dy)
    dx = F.conv_transpose2d(dy.permute(0, 3, 1, 2).to(acc),
                            wp.permute(3, 2, 0, 1).to(acc), padding=1)
    return dx.permute(0, 2, 3, 1).to(dy.dtype).contiguous()


def packed_conv_dw_reference(xh: torch.Tensor,
                             dy: torch.Tensor) -> torch.Tensor:
    """Plain dw in f32: the nine shifted products
    ``dw[kh, kw] = sum_pixels x[h + kh - 1, w + kw - 1]^T dy[h, w]``."""
    acc = _acc_dtype(xh)
    _, H, W, _ = xh.shape
    xpad = F.pad(xh.to(acc), (0, 0, 1, 1, 1, 1))
    dyf = dy.to(acc)
    return torch.stack([torch.stack([
        torch.einsum("bhwc,bhwf->cf", xpad[:, kh:kh + H, kw:kw + W], dyf)
        for kw in range(3)]) for kh in range(3)])


@functools.cache
def _kernel(kind: str, dtype: torch.dtype):
    fn = getattr(load_library("packed_conv"),
                 f"packed_conv_{kind}_{_SUFFIX[dtype]}")
    if kind == "fwd":   # x, w, y, BD, H, W, Cin, Cout, stream
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
    else:               # x, dy, part, dw, BD, H, W, Cin, Cout, splits, stream
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _dw_splits():
    fn = load_library("packed_conv").packed_conv_dw_splits
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    return fn


def _check_pair(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 4 or b.dim() != 4:
        raise ValueError(f"{name} wants 4-D tensors, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    cpu64 = a.dtype == torch.float64 and a.device.type == "cpu"
    if (a.dtype not in _SUFFIX and not cpu64) or b.dtype != a.dtype:
        raise TypeError(f"{name} takes bf16 or f32 (f64 on the CPU) with "
                        f"matching types, got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {a.device}")


def _check(xh: torch.Tensor, wp: torch.Tensor) -> None:
    _check_pair("packed_conv", xh, wp)
    if tuple(wp.shape[:3]) != (3, 3, xh.shape[-1]):
        raise ValueError(f"packed_conv: wp {tuple(wp.shape)} does not match "
                         f"xh {tuple(xh.shape)}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _launch_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward kernel on contiguous CUDA tensors (no count)."""
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("packed_conv wants contiguous operands")
    BD, H, W, Cin = x.shape
    Cout = w.shape[-1]
    y = torch.empty((BD, H, W, Cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        _raise_on(_kernel("fwd", x.dtype)(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), BD, H, W, Cin, Cout,
            torch.cuda.current_stream().cuda_stream), "packed_conv")
    return y


def _forward(xh: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    if xh.device.type == "cpu":
        return packed_conv_reference(xh, wp)
    y = _launch_conv(xh, wp)
    packed_conv.launches += 1
    return y


class _PackedConv(torch.autograd.Function):
    """``packed_conv`` with the TPU kernel's custom VJP: dx by the forward
    kernel on the flipped band, dw by the split-reduction kernel. Only the
    gradients autograd asks for are computed."""

    @staticmethod
    def forward(ctx, xh, wp):
        ctx.save_for_backward(xh, wp)
        return _forward(xh, wp)

    @staticmethod
    def backward(ctx, dy):
        xh, wp = ctx.saved_tensors
        dy = dy.contiguous()  # the unpack views hand back strided grads
        dx = packed_conv_dx(dy, wp) if ctx.needs_input_grad[0] else None
        dw = (packed_conv_dw(xh, dy).to(wp.dtype)
              if ctx.needs_input_grad[1] else None)
        return dx, dw


def packed_conv(xh: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """3x3 (H, W) conv with torch-style padding on flattened packed rows;
    differentiable in both operands."""
    _check(xh, wp)
    if torch.is_grad_enabled() and (xh.requires_grad or wp.requires_grad):
        return _PackedConv.apply(xh, wp)
    return _forward(xh, wp)


def packed_conv_dx(dy: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """Input gradient of ``packed_conv``: dy [BD, H, W, Cout] and wp
    [3, 3, Cin, Cout] -> dx [BD, H, W, Cin] in dy's dtype."""
    _check_pair("packed_conv_dx", dy, wp)
    if wp.shape[:2] != (3, 3) or wp.shape[-1] != dy.shape[-1]:
        raise ValueError(f"packed_conv_dx: wp {tuple(wp.shape)} does not "
                         f"match dy {tuple(dy.shape)}")
    if dy.device.type == "cpu":
        return packed_conv_dx_reference(dy, wp)
    wflip = wp.flip(0, 1).transpose(2, 3).contiguous()  # [3, 3, Cout, Cin]
    dx = _launch_conv(dy, wflip)
    packed_conv_dx.launches += 1
    return dx


def packed_conv_dw(xh: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of ``packed_conv``: xh [BD, H, W, Cin] and dy
    [BD, H, W, Cout] -> f32 [3, 3, Cin, Cout]."""
    _check_pair("packed_conv_dw", xh, dy)
    if xh.shape[:3] != dy.shape[:3]:
        raise ValueError(f"packed_conv_dw: xh {tuple(xh.shape)} and dy "
                         f"{tuple(dy.shape)} differ in [BD, H, W]")
    if xh.device.type == "cpu":
        return packed_conv_dw_reference(xh, dy)
    if not (xh.is_contiguous() and dy.is_contiguous()):
        raise ValueError("packed_conv_dw wants contiguous xh and dy")
    BD, H, W, Cin = xh.shape
    Cout = dy.shape[-1]
    dw = torch.zeros((3, 3, Cin, Cout), dtype=torch.float32,
                     device=xh.device)
    if xh.numel() == 0 or dw.numel() == 0:
        return dw
    bf16 = xh.dtype == torch.bfloat16
    with torch.cuda.device(xh.device):
        splits = _dw_splits()(BD, H, W, Cin, Cout, int(bf16))
        part = torch.empty((splits, 3, 3, Cin, Cout), dtype=torch.float32,
                           device=xh.device)
        _raise_on(_kernel("dw", xh.dtype)(
            xh.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
            BD, H, W, Cin, Cout, splits,
            torch.cuda.current_stream().cuda_stream), "packed_conv_dw")
    packed_conv_dw.launches += 1
    return dw


packed_conv.launches = 0
packed_conv_dx.launches = 0
packed_conv_dw.launches = 0
