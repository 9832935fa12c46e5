"""Fused window attention of the 3D Swin encoder: CUDA kernels and their
plain versions.

``fused_window_attention(q, k, v, bias, region)`` is the port of the Pallas
TPU kernel ``transoar_tpu/ops/pallas/window_attention.py::
fused_window_attention``, with its signature and layout: q (pre-scaled), k,
v ``[B_, H, N, d]``; the learned relative-position bias ``[H, N, N]`` (f32);
the shift-region labels ``region [nW, N]`` with nW dividing B_ (window b
uses row b % nW; a zero ``[1, N]`` region masks nothing). Per window and
head it returns ``softmax(q k^T + bias + mask) v`` in q's dtype, computed in
f32, where the mask is -100 between tokens whose labels differ. Where
autograd needs it the call goes through ``_WindowAttention``, whose
backward mirrors ``_bwd_rule``: ``fused_window_attention_bwd`` recomputes
the probabilities and returns dq, dk, dv (in the inputs' dtypes) and the
f32 dbias summed over every window; the region gets no gradient.

On a CUDA tensor each of the two launches its hand-written kernel in
``csrc/window_attention.cu`` (built with nvcc for sm_90a at first use) or
raises; it never falls back. The kernels take N <= 128 and d a multiple of 8
up to 64, in bf16 (tensor cores) or f32 (CUDA cores). q, k, v and do are
passed as strided views (the last axis contiguous), and the outputs come
back as ``[B_, H, N, d]`` views of ``[B_, N, H, d]`` memory, so the Swin
module's head split and merge cost no copy. On a CPU tensor each runs its
plain PyTorch version (``window_attention_reference``,
``window_attention_bwd_reference``), which the CPU tests and the on-card
checks compare against; the CPU also takes f64, for ``gradcheck``. Each
wrapper counts its own launches (``fused_window_attention.launches``,
``fused_window_attention_bwd.launches``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from transoar_tpu_torch.ops.kernels._build import load_library

N_MAX, D_MAX = 128, 64


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """f32, or f64 for f64 inputs (the CPU's gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _probs(q, k, bias, region):
    """[B_, H, N, N] softmax probabilities in f32 (f64 for f64)."""
    acc = _acc_dtype(q)
    B, H, N, _ = q.shape
    nW = region.shape[0]
    s = torch.einsum("bhnd,bhmd->bhnm", q.to(acc), k.to(acc)) + bias.to(acc)
    mask = torch.where(region[:, :, None] != region[:, None, :], -100.0, 0.0)
    s = s.view(B // nW, nW, H, N, N) + mask.to(acc)[None, :, None]
    return s.view(B, H, N, N).softmax(-1)


def window_attention_reference(q, k, v, bias, region):
    """Plain forward: the math of ``reference_window_attention``, in f32
    throughout (as the TPU kernel), output in q's dtype."""
    p = _probs(q, k, bias, region)
    return torch.einsum("bhnm,bhmd->bhnd", p, v.to(p.dtype)).to(q.dtype)


def window_attention_bwd_reference(q, k, v, bias, region, do):
    """Plain backward in f32: (dq, dk, dv) in the inputs' dtypes and dbias
    ``[H, N, N]`` summed over the windows."""
    p = _probs(q, k, bias, region)
    acc = p.dtype
    dof = do.to(acc)
    dv = torch.einsum("bhnm,bhnd->bhmd", p, dof)
    dp = torch.einsum("bhnd,bhmd->bhnm", dof, v.to(acc))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhnm,bhmd->bhnd", ds, k.to(acc))
    dk = torch.einsum("bhnm,bhnd->bhmd", ds, q.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.sum(0)


@functools.cache
def _kernel(name: str):
    fn = getattr(load_library("window_attention"), f"window_attention_{name}")
    ptrs = {"fwd": 6, "bwd": 11}.get(name)
    if ptrs is None:  # chunks: B, H
        fn.argtypes = [ctypes.c_int] * 2
    else:  # f32, pointers, strides, B, H, N, d, nW[, chunks], stream
        ints = 5 if name == "fwd" else 6
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * ptrs
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * ints + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name, q, k, v, bias, region, do=None):
    heads = [q, k, v] + ([] if do is None else [do])
    if any(t.dim() != 4 or t.shape != q.shape for t in heads):
        raise ValueError(f"{name} wants [B_, H, N, d] operands of one "
                         f"shape, got {[tuple(t.shape) for t in heads]}")
    B, H, N, d = q.shape
    if tuple(bias.shape) != (H, N, N):
        raise ValueError(f"{name}: bias {tuple(bias.shape)}, want "
                         f"{(H, N, N)}")
    if region.dim() != 2 or region.shape[1] != N or region.shape[0] < 1 \
            or B % region.shape[0]:
        raise ValueError(f"{name}: region {tuple(region.shape)} is not "
                         f"[nW, {N}] with nW dividing {B}")
    devices = {t.device for t in heads + [bias, region]}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on {sorted(map(str, devices))}")
    dev = q.device
    cpu64 = q.dtype == torch.float64 and dev.type == "cpu"
    if any(t.dtype != q.dtype for t in heads) or not (
            q.dtype in (torch.bfloat16, torch.float32) or cpu64):
        raise TypeError(f"{name} takes bf16 or f32 (f64 on the CPU) q, k, v"
                        f" of one dtype, got {[t.dtype for t in heads]}")
    if dev.type == "cuda" and not (N <= N_MAX and d % 8 == 0
                                   and 8 <= d <= D_MAX):
        raise ValueError(f"{name}'s kernel takes N <= {N_MAX} and d a "
                         f"multiple of 8 up to {D_MAX}, got N {N}, d {d}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")


def _operand(t: torch.Tensor) -> torch.Tensor:
    """A view the kernel can read: last axis contiguous and, for bf16, every
    row 16-byte aligned; else a contiguous copy."""
    ok = t.stride(-1) == 1
    if ok and t.dtype == torch.bfloat16:
        ok = t.data_ptr() % 16 == 0 and all(s % 8 == 0
                                             for s in t.stride()[:3])
    return t if ok else t.contiguous()


def _heads_out(like: torch.Tensor) -> torch.Tensor:
    """[B_, H, N, d] view of fresh [B_, N, H, d] memory."""
    B, H, N, d = like.shape
    return torch.empty((B, N, H, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _strides(*tensors):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _forward(q, k, v, bias, region):
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, bias, region)
    q, k, v = _operand(q), _operand(k), _operand(v)
    bias = bias.to(torch.float32).contiguous()
    region = region.to(torch.float32).contiguous()
    B, H, N, d = q.shape
    o = _heads_out(q)
    if o.numel():
        with torch.cuda.device(q.device):
            _raise_on(_kernel("fwd")(
                int(q.dtype == torch.float32), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), bias.data_ptr(), region.data_ptr(), o.data_ptr(),
                _strides(q, k, v, o), B, H, N, d, region.shape[0],
                torch.cuda.current_stream().cuda_stream),
                "fused_window_attention")
        fused_window_attention.launches += 1
    return o


class _WindowAttention(torch.autograd.Function):
    """``fused_window_attention`` with the TPU kernel's custom VJP: the
    backward kernel recomputes the probabilities from the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, bias, region):
        ctx.save_for_backward(q, k, v, bias, region)
        return _forward(q, k, v, bias, region)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, region = ctx.saved_tensors
        dq, dk, dv, dbias = fused_window_attention_bwd(q, k, v, bias, region,
                                                       do)
        return dq, dk, dv, dbias.to(bias.dtype), None


def fused_window_attention(q, k, v, bias, region):
    """q, k, v [B_, H, N, d] (q pre-scaled), bias [H, N, N], region [nW, N]
    -> [B_, H, N, d] in q's dtype; differentiable in q, k, v and bias."""
    _check("fused_window_attention", q, k, v, bias, region)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, bias)):
        return _WindowAttention.apply(q, k, v, bias, region)
    return _forward(q, k, v, bias, region)


def fused_window_attention_bwd(q, k, v, bias, region, do):
    """Gradients of ``fused_window_attention`` for the output gradient
    ``do``: (dq, dk, dv) in the inputs' dtypes and dbias f32 [H, N, N]."""
    _check("fused_window_attention_bwd", q, k, v, bias, region, do)
    if q.device.type == "cpu":
        return window_attention_bwd_reference(q, k, v, bias, region, do)
    q, k, v, do = (_operand(t) for t in (q, k, v, do))
    bias = bias.to(torch.float32).contiguous()
    region = region.to(torch.float32).contiguous()
    B, H, N, d = q.shape
    dq, dk, dv = _heads_out(q), _heads_out(q), _heads_out(q)
    dbias = torch.zeros((H, N, N), dtype=torch.float32, device=q.device)
    if q.numel():
        with torch.cuda.device(q.device):
            chunks = _kernel("bwd_chunks")(B, H)
            part = torch.empty((chunks, H, N, N), dtype=torch.float32,
                               device=q.device)
            _raise_on(_kernel("bwd")(
                int(q.dtype == torch.float32), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), bias.data_ptr(), region.data_ptr(),
                do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                part.data_ptr(), dbias.data_ptr(),
                _strides(q, k, v, do, dq, dk, dv), B, H, N, d,
                region.shape[0], chunks,
                torch.cuda.current_stream().cuda_stream),
                "fused_window_attention_bwd")
        fused_window_attention_bwd.launches += 1
    return dq, dk, dv, dbias


fused_window_attention.launches = 0
fused_window_attention_bwd.launches = 0
