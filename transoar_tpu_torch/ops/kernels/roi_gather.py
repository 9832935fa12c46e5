"""The Focused Decoder's RoI gather of keys and values, with its backward
as a segment sum over the gather's inverse index.

``roi_gather(k, v, flat, inv_offsets, inv_slots)`` takes k, v ``[B, S,
*row]`` and the static gather index ``flat`` ``[N]`` (each organ's tokens,
pad slots included) and returns ``k[:, flat]`` and ``v[:, flat]`` (one
``index_select`` each). Its backward adds the gradient of every slot
that reads a token into that token: ``roi_gather_bwd`` over the inverse
index in CSR form, built once with the model
(``models.focused_decoder.roi_inverse_index``): the slots reading token s
are ``inv_slots[inv_offsets[s]:inv_offsets[s + 1]]``, ascending, pad slots
left out (their softmax weight, and so their gradient, is exactly 0 in
f32). Sums are f32, in that fixed order, written once in the gradient's
dtype; a token no slot reads gets zeros.

On a CUDA tensor ``roi_gather_bwd`` launches its hand-written kernel in
``csrc/roi_gather.cu`` (one launch for dK and dV, built with nvcc for
sm_90a at first use; bf16 or f32 rows of any multiple of 16 bytes) or
raises; it never falls back. On a CPU tensor it runs its plain version
``roi_gather_bwd_reference`` (also f64, for ``gradcheck``). The kernel
replaces no TPU kernel: the JAX package leaves the gather and its
scatter-add backward to XLA (``take``). On the card that backward was
PyTorch's sort-based ``index_put_(accumulate=True)``
(``indexing_backward_kernel``), serial over the ~7,000 pad slots that all
point at token 0; the source says what bounds the kernel and how its
design meets that. The gradient is read in place where its rows are
contiguous and 16-byte aligned (as the attention's einsum hands it over);
otherwise it is copied once, contiguous.

``roi_gather_bwd.launches`` counts the kernel's launches (one a decoder
layer a train step on the card); ``KERNELS`` names its device function as
the profiler's trace names it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from transoar_tpu_torch.ops.kernels._build import load_library

KERNELS = ("roi_segment_sum",)
_P, _I = ctypes.c_void_p, ctypes.c_int
# f32, gk, gv, dk, dv, strides, offsets, slots, B, S, W, stream
_ARGTYPES = ([_I] + [_P] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
             + [_P] * 2 + [_I] * 3 + [_P])


@functools.cache
def _kernel():
    fn = load_library("roi_gather").roi_gather_bwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def roi_gather_bwd_reference(gk: torch.Tensor, gv: torch.Tensor,
                             inv_offsets: torch.Tensor,
                             inv_slots: torch.Tensor, num_tokens: int):
    """Plain version: gk, gv [B, N, *row] -> dK, dV [B, num_tokens, *row],
    each token's slots added in CSR order in f32 (f64 for f64), cast to the
    gradient's dtype."""
    counts = inv_offsets.long().diff()
    tokens = torch.repeat_interleave(
        torch.arange(num_tokens, device=counts.device), counts)
    slots = inv_slots[:tokens.numel()].long()

    def one(g):
        acc = torch.float64 if g.dtype == torch.float64 else torch.float32
        out = g.new_zeros((g.shape[0], num_tokens, *g.shape[2:]), dtype=acc)
        out.index_add_(1, tokens, g.to(acc).index_select(1, slots))
        return out.to(g.dtype)

    return one(gk), one(gv)


def _operand(g: torch.Tensor) -> torch.Tensor:
    """g [B, N, *row] as the kernel reads it: [B, N, W] with contiguous
    rows and every 16-byte vector aligned; a copy only where the view it
    came as has no such form."""
    B, N = g.shape[:2]
    v = g.reshape(B, N, -1)  # a view where the rows allow
    vec = 16 // g.element_size()
    if (v.stride(2) == 1 and v.data_ptr() % 16 == 0
            and v.stride(0) % vec == 0 and v.stride(1) % vec == 0):
        return v
    return v.clone(memory_format=torch.contiguous_format)  # a new block


def roi_gather_bwd(gk: torch.Tensor, gv: torch.Tensor,
                   inv_offsets: torch.Tensor, inv_slots: torch.Tensor,
                   num_tokens: int):
    """gk, gv [B, N, *row] (the gathered keys' and values' gradients) ->
    dK, dV [B, num_tokens, *row]."""
    if gk.shape != gv.shape or gk.dtype != gv.dtype or gk.dim() < 3:
        raise ValueError(f"roi_gather_bwd wants two [B, N, *row] gradients "
                         f"of one shape and dtype, got {tuple(gk.shape)} "
                         f"{gk.dtype} and {tuple(gv.shape)} {gv.dtype}")
    if inv_offsets.shape != (num_tokens + 1,):
        raise ValueError(f"roi_gather_bwd: inv_offsets of shape "
                         f"{tuple(inv_offsets.shape)} for {num_tokens} tokens")
    if gk.device.type == "cpu":
        return roi_gather_bwd_reference(gk, gv, inv_offsets, inv_slots,
                                        num_tokens)
    B, W = gk.shape[0], math.prod(gk.shape[2:])
    if (gk.device.type != "cuda"
            or gk.dtype not in (torch.bfloat16, torch.float32)
            or W * gk.element_size() % 16):
        raise TypeError(f"roi_gather_bwd's kernel takes bf16 or f32 CUDA "
                        f"rows of a multiple of 16 bytes, got {W} x "
                        f"{gk.dtype} on {gk.device}")
    if (inv_offsets.dtype != torch.int32 or inv_slots.dtype != torch.int32
            or inv_offsets.device != gk.device
            or inv_slots.device != gk.device):
        raise TypeError("roi_gather_bwd: the inverse index must be int32 on "
                        "the gradients' device")
    k, v = _operand(gk), _operand(gv)
    dk = torch.empty((B, num_tokens, *gk.shape[2:]), dtype=gk.dtype,
                     device=gk.device)
    dv = torch.empty_like(dk)
    offsets, slots = inv_offsets.contiguous(), inv_slots.contiguous()
    strides = (ctypes.c_longlong * 4)(*k.stride()[:2], *v.stride()[:2])
    with torch.cuda.device(gk.device):
        err = _kernel()(int(gk.dtype == torch.float32), k.data_ptr(),
                        v.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides,
                        offsets.data_ptr(), slots.data_ptr(), B, num_tokens,
                        W, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_gather_bwd kernel launch failed: cudaError "
                           f"{err}")
    roi_gather_bwd.launches += 1
    return dk, dv


roi_gather_bwd.launches = 0


class _RoIGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, k, v, flat, inv_offsets, inv_slots):
        ctx.save_for_backward(inv_offsets, inv_slots)
        ctx.num_tokens = k.shape[1]
        return k.index_select(1, flat), v.index_select(1, flat)

    @staticmethod
    @once_differentiable
    def backward(ctx, gk, gv):
        inv_offsets, inv_slots = ctx.saved_tensors
        dk, dv = roi_gather_bwd(gk, gv, inv_offsets, inv_slots,
                                ctx.num_tokens)
        return dk, dv, None, None, None


def roi_gather(k: torch.Tensor, v: torch.Tensor, flat: torch.Tensor,
               inv_offsets: torch.Tensor, inv_slots: torch.Tensor):
    """k, v [B, S, *row]; flat [N] long; the inverse index of ``flat``'s
    live slots -> (k[:, flat], v[:, flat]) [B, N, *row]."""
    return _RoIGather.apply(k, v, flat, inv_offsets, inv_slots)
