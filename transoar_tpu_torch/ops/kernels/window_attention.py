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
up to 64, in bf16 (tensor cores) or f32 (CUDA cores). Each direction has
three kernels for its one function, chosen by shape in ``_window_variant``:
``wg`` (bf16, d = 16: ``fwd_wg`` / ``bwd_wg``, wgmma fed by a TMA ring, each
block one head and a run of windows as ``_wg_split`` assigns them; every
Swin launch of the SwinFPN), ``generic`` (``fwd_mma`` / ``bwd_mma``, every
other bf16 shape) and ``fma`` (f32). A launch that fails raises; nothing
retries on another variant. q, k, v and do are passed as strided views (the
last axis contiguous), and the outputs come back as ``[B_, H, N, d]`` views
of ``[B_, N, H, d]`` memory, so the Swin module's head split and merge cost
no copy. On a CPU tensor each runs its plain PyTorch version
(``window_attention_reference``, ``window_attention_bwd_reference``), which
the CPU tests and the on-card checks compare against; the CPU also takes
f64, for ``gradcheck``. Each wrapper counts its own launches
(``fused_window_attention.launches``,
``fused_window_attention_bwd.launches``), and the kernels count theirs per
variant (``variant_launches``, ``bwd_variant_launches``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from transoar_tpu_torch.ops.kernels._build import load_library

N_MAX, D_MAX, WG_D = 128, 64, 16
_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# the C interface of csrc/window_attention.cu, symbol -> argument types
_ARGTYPES = {
    # f32, q, k, v, bias, region, o, strides, B, H, N, d, nW, stream
    "window_attention_fwd": [_I] + [_P] * 6 + [_STRIDES] + [_I] * 5 + [_P],
    # f32, q, k, v, bias, region, do, dq, dk, dv, part, dbias, strides, B,
    # H, N, d, nW, chunks, stream
    "window_attention_bwd": [_I] + [_P] * 11 + [_STRIDES] + [_I] * 6 + [_P],
    "window_attention_bwd_chunks": [_I] * 2,  # B, H
    # q, k, v, bias, region [nW, 128], o, strides, B, H, N, nW, wpb, stream
    "window_attention_fwd_wg": [_P] * 6 + [_STRIDES] + [_I] * 5 + [_P],
    # ... do, dq, dk, dv, part, dbias, strides, B, H, N, nW, wpb, chunks
    "window_attention_bwd_wg": [_P] * 11 + [_STRIDES] + [_I] * 6 + [_P],
    "window_attention_wg_blocks_per_sm": [_I, ctypes.POINTER(_I)],
    "window_attention_kernel_attrs": [_I, ctypes.POINTER(_I)],
    "window_attention_debug_wgmma_tile": [_P] * 7,
}
_VARIANTS = ("wg", "generic", "fma")
variant_launches = dict.fromkeys(_VARIANTS, 0)       # the forward kernels
bwd_variant_launches = dict.fromkeys(_VARIANTS, 0)   # the backward kernels
_ATTRS = ("fwd_mma", "bwd_mma", "fwd_wg", "bwd_wg")


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
def _kernel(symbol: str):
    fn = getattr(load_library("window_attention"), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def _window_variant(q: torch.Tensor) -> str:
    """The kernel for q [B_, H, N, d]: "wg" (bf16, d = 16, N <= 128: every
    Swin launch of the SwinFPN), "generic" for every other bf16 shape, "fma"
    for f32. The operands the kernels get are 16-byte aligned with strides
    in multiples of 8 elements (``_operand``), as the wg kernels' tensor
    maps need."""
    if q.dtype != torch.bfloat16:
        return "fma"
    N, d = q.shape[2:]
    return "wg" if d == WG_D and N <= N_MAX else "generic"


def _wg_split(B: int, H: int, target: int) -> tuple[int, int]:
    """The wg kernels' static assignment: each block takes one head and a
    run of ``wpb`` consecutive windows; ``target`` blocks (the SMs times the
    blocks one SM holds) are shared among the H heads, so the grid is
    ``chunks`` runs x H heads with chunks = ceil(B / wpb). Returns (wpb,
    chunks)."""
    per_head = max(1, min(B, target // H))
    wpb = -(-B // per_head)
    return wpb, -(-B // wpb)


@functools.cache
def _wg_target(device_index: int, bwd: bool) -> int:
    per_sm = ctypes.c_int()
    _raise_on(_kernel("window_attention_wg_blocks_per_sm")(
        int(bwd), ctypes.byref(per_sm)), "window_attention_wg_blocks_per_sm")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * max(1, per_sm.value)


def kernel_attrs(name: str) -> dict:
    """Registers, static and dynamic shared memory and local (spill) bytes
    per thread of the bf16 kernel ``name``: fwd_mma, bwd_mma (the generic
    kernels at d = 16), fwd_wg or bwd_wg."""
    out = (ctypes.c_int * 4)()
    _raise_on(_kernel("window_attention_kernel_attrs")(_ATTRS.index(name),
                                                       out),
              f"window_attention_kernel_attrs({name})")
    return dict(zip(("registers", "static_smem", "local_bytes",
                     "dynamic_smem"), out))


def _debug_wgmma_tile(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor):
    """One tile of each wgmma form of the wg kernels on the card: a [64, 16],
    b and v [128, 16] bf16 -> (s, o, t) f32 with s = a b^T [64, 128] (the
    score tile), o = bf16(s) v [64, 16] (A from registers) and t =
    bf16(s)^T a [128, 16] (A read MN-major from the staging layout). It pins
    the descriptor and swizzle conventions of the wg kernels."""
    dev = a.device
    s = torch.empty((64, N_MAX), dtype=torch.float32, device=dev)
    o = torch.empty((64, WG_D), dtype=torch.float32, device=dev)
    t = torch.empty((N_MAX, WG_D), dtype=torch.float32, device=dev)
    a, b, v = (x.contiguous() for x in (a, b, v))
    with torch.cuda.device(dev):
        _raise_on(_kernel("window_attention_debug_wgmma_tile")(
            a.data_ptr(), b.data_ptr(), v.data_ptr(), s.data_ptr(),
            o.data_ptr(), t.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "debug_wgmma_tile")
    return s, o, t


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


def _pick(name: str, q: torch.Tensor, variant: str | None) -> str:
    """The variant ``_window_variant`` picks, or ``variant`` where it is
    "generic", which takes every bf16 shape (the on-card timing and checks
    of the wg kernels against it)."""
    picked = _window_variant(q)
    if variant is None or variant == picked:
        return picked
    if variant == "generic" and picked != "fma":
        return variant
    raise ValueError(f"{name}: the {variant} kernel does not take "
                     f"{tuple(q.shape)} {q.dtype}")


def _labels(region: torch.Tensor, variant: str) -> torch.Tensor:
    """The region labels as the kernels read them: contiguous f32 [nW, N],
    padded to [nW, 128] with zeros for the wg kernels (one 512-byte bulk
    copy a window). The padded copy is kept on ``region`` itself (the Swin
    module's labels are constants built once per shape) and made anew when
    ``region`` was changed in place."""
    if variant != "wg":
        return region.to(torch.float32).contiguous()
    version = None if region.is_inference() else region._version
    kept = getattr(region, "_wg_labels", None)
    if version is not None and kept is not None and kept[0] == version:
        return kept[1]
    padded = F.pad(region.to(torch.float32),
                   (0, N_MAX - region.shape[1])).contiguous()
    if version is not None:
        region._wg_labels = (version, padded)
    return padded


def _launch_fwd(q, k, v, bias, region, variant=None):
    """The forward kernel on CUDA tensors (checked by the caller): the one
    ``_window_variant`` picks, or "generic". Counts the launch in
    ``variant_launches``, not in the wrapper's count."""
    variant = _pick("fused_window_attention", q, variant)
    q, k, v = _operand(q), _operand(k), _operand(v)
    bias = bias.to(torch.float32).contiguous()
    region = _labels(region, variant)
    B, H, N, d = q.shape
    o = _heads_out(q)
    if not o.numel():
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                region.data_ptr(), o.data_ptr())
        strides = _strides(q, k, v, o)
        if variant == "wg":
            wpb, _ = _wg_split(B, H, _wg_target(q.device.index, False))
            err = _kernel("window_attention_fwd_wg")(
                *ptrs, strides, B, H, N, region.shape[0], wpb, stream)
        else:
            err = _kernel("window_attention_fwd")(
                int(variant == "fma"), *ptrs, strides, B, H, N, d,
                region.shape[0], stream)
        _raise_on(err, f"fused_window_attention ({variant})")
    variant_launches[variant] += 1
    return o


def _forward(q, k, v, bias, region):
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, bias, region)
    o = _launch_fwd(q, k, v, bias, region)
    if o.numel():
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


def _launch_bwd(q, k, v, bias, region, do, variant=None):
    """The backward kernel on CUDA tensors (checked by the caller), as
    ``_launch_fwd``; counts the launch in ``bwd_variant_launches``."""
    variant = _pick("fused_window_attention_bwd", q, variant)
    q, k, v, do = (_operand(t) for t in (q, k, v, do))
    bias = bias.to(torch.float32).contiguous()
    region = _labels(region, variant)
    B, H, N, d = q.shape
    dq, dk, dv = _heads_out(q), _heads_out(q), _heads_out(q)
    dbias = torch.zeros((H, N, N), dtype=torch.float32, device=q.device)
    if not q.numel():
        return dq, dk, dv, dbias
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "wg":
            wpb, chunks = _wg_split(B, H, _wg_target(q.device.index, True))
        else:
            chunks = _kernel("window_attention_bwd_chunks")(B, H)
        part = torch.empty((chunks, H, N, N), dtype=torch.float32,
                           device=q.device)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                region.data_ptr(), do.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), part.data_ptr(),
                dbias.data_ptr())
        strides = _strides(q, k, v, do, dq, dk, dv)
        if variant == "wg":
            err = _kernel("window_attention_bwd_wg")(
                *ptrs, strides, B, H, N, region.shape[0], wpb, chunks,
                stream)
        else:
            err = _kernel("window_attention_bwd")(
                int(variant == "fma"), *ptrs, strides, B, H, N, d,
                region.shape[0], chunks, stream)
        _raise_on(err, f"fused_window_attention_bwd ({variant})")
    bwd_variant_launches[variant] += 1
    return dq, dk, dv, dbias


def fused_window_attention_bwd(q, k, v, bias, region, do):
    """Gradients of ``fused_window_attention`` for the output gradient
    ``do``: (dq, dk, dv) in the inputs' dtypes and dbias f32 [H, N, N]."""
    _check("fused_window_attention_bwd", q, k, v, bias, region, do)
    if q.device.type == "cpu":
        return window_attention_bwd_reference(q, k, v, bias, region, do)
    grads = _launch_bwd(q, k, v, bias, region, do)
    if q.numel():
        fused_window_attention_bwd.launches += 1
    return grads


fused_window_attention.launches = 0
fused_window_attention_bwd.launches = 0
