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
  deterministic; the backward casts it to ``wp``'s dtype. Its bf16 kernels
  are chosen by shape in ``_dw_variant`` as the forward's: ``wide`` (Cin %
  16 == 0 where its ring fits, wgmma with the taps' kh folded into M),
  ``fold`` (Cin 2, 4 or 6: all nine taps folded into M = 64) and
  ``generic`` (the mma.sync kernel); f32 runs ``fma``.

Each of the three, on a CUDA tensor, launches its hand-written kernel in
``csrc/packed_conv.cu`` (built with nvcc for sm_90a at first use) or raises;
it never falls back. The forward (and so dx) has three bf16 kernels for
one function, chosen by shape in ``_variant``: ``wide`` (Cin % 8 == 0, on
wgmma with an asynchronous copy ring), ``fold`` (Cin 2, 4 or 6: the nine
taps folded into K = 64) and ``generic`` (the mma.sync kernel, for every
other shape); f32 runs ``fma``. A launch that fails raises; nothing retries
on another variant. The wide and fold kernels take the band re-laid out
here (``_wide_weight``, ``_fold_weight``). On a CPU tensor each wrapper
runs its plain PyTorch version
(``packed_conv_reference``, ``packed_conv_dx_reference``,
``packed_conv_dw_reference``), which the CPU tests and the on-card checks
compare against; the CPU also takes f64, for ``gradcheck``. Each wrapper
counts its own launches (``packed_conv.launches``,
``packed_conv_dx.launches``, ``packed_conv_dw.launches``); the forward
kernel also counts its launches per variant in ``variant_launches``,
whichever wrapper called it, and the dw kernels theirs in
``dw_variant_launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from transoar_tpu_torch.ops.kernels._build import load_library

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
# the forward kernels by variant, and the output widths the wgmma paths are
# built for (a template each in csrc/packed_conv.cu)
_FWD_SYMBOL = {"wide": "packed_conv_fwd_wide", "fold": "packed_conv_fwd_fold",
               "generic": "packed_conv_fwd_bf16", "fma": "packed_conv_fwd_f32"}
WGMMA_COUT = (64, 96, 144)
FOLD_CIN = (2, 4, 6)
FOLD_K = 64
variant_launches = dict.fromkeys(_FWD_SYMBOL, 0)
# the weight-gradient kernels by variant (the index is the C side's)
_DW_SYMBOL = {"generic": "packed_conv_dw_bf16", "wide": "packed_conv_dw_wide",
              "fold": "packed_conv_dw_fold", "fma": "packed_conv_dw_f32"}
dw_variant_launches = dict.fromkeys(_DW_SYMBOL, 0)


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


def _variant(x: torch.Tensor, w: torch.Tensor) -> str:
    """The forward kernel for x [BD, H, W, Cin] and w [3, 3, Cin, Cout]:
    "wide" (bf16, Cin % 8 == 0), "fold" (bf16, Cin 2, 4 or 6 and
    W * Cin % 8 == 0, so that every input row is 16-byte aligned), both for
    Cout 64, 96 or 144 and a 16-byte aligned x; "generic" for every other
    bf16 shape; "fma" for f32."""
    if x.dtype != torch.bfloat16:
        return "fma"
    cin, cout = x.shape[-1], w.shape[-1]
    if cout not in WGMMA_COUT or x.data_ptr() % 16:
        return "generic"
    if cin % 8 == 0:
        return "wide"
    if cin in FOLD_CIN and x.shape[2] * cin % 8 == 0:
        return "fold"
    return "generic"


def _dw_variant(x: torch.Tensor, dy: torch.Tensor) -> str:
    """The dw kernel for x [BD, H, W, Cin] and dy [BD, H, W, Cout]: "wide"
    (bf16, Cin % 16 == 0), "fold" (bf16, Cin 2, 4 or 6 and W * Cin % 8 ==
    0), both for Cout 64, 96 or 144 and 16-byte aligned x and dy; "generic"
    for every other bf16 shape; "fma" for f32. On a CUDA tensor "wide" also
    needs two stages of its ring to fit in shared memory, the C side's rule
    (``packed_conv_dw_wide_fits``); the CPU runs the plain version whatever
    the variant, so it does not build the library to ask."""
    if x.dtype != torch.bfloat16:
        return "fma"
    cin, cout = x.shape[-1], dy.shape[-1]
    if cout not in WGMMA_COUT or x.data_ptr() % 16 or dy.data_ptr() % 16:
        return "generic"
    if cin % 16 == 0 and (x.device.type != "cuda"
                          or _dw_wide_fits(cin, cout)):
        return "wide"
    if cin in FOLD_CIN and x.shape[2] * cin % 8 == 0:
        return "fold"
    return "generic"


def _wide_weight(w: torch.Tensor) -> torch.Tensor:
    """The band [3, 3, Cin, Cout] as the wide kernel streams it:
    [ceil(Cin / 16), 9, 2, Cout, 8] = per 16-channel chunk, per tap, the two
    8-channel halves K-major (channel 16 c + 8 h + j at [c, tap, h, :, j]),
    zero past Cin. One chunk is one contiguous bulk copy."""
    _, _, cin, cout = w.shape
    chunks = -(-cin // 16)
    wpad = F.pad(w.reshape(9, cin, cout), (0, 0, 0, 16 * chunks - cin))
    return (wpad.reshape(9, chunks, 2, 8, cout).permute(1, 0, 2, 4, 3)
            .contiguous())


def _fold_weight(w: torch.Tensor) -> torch.Tensor:
    """The band [3, 3, Cin, Cout] folded for the fold kernel: the [64, Cout]
    matrix of K = tap * Cin + ci (zero rows past 9 Cin), laid out K-major
    as [8, Cout, 8] (row 8 g + j at [g, :, j])."""
    _, _, cin, cout = w.shape
    w64 = F.pad(w.reshape(9 * cin, cout), (0, 0, 0, FOLD_K - 9 * cin))
    return w64.reshape(FOLD_K // 8, 8, cout).transpose(1, 2).contiguous()


_RELAYOUT = {"wide": _wide_weight, "fold": _fold_weight}


@functools.cache
def _kernel(symbol: str):
    fn = getattr(load_library("packed_conv"), symbol)
    if symbol == "packed_conv_debug_wgmma_mn":
        # a, b, d, swa, swb, swap, rs, stream
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
    elif symbol.startswith("packed_conv_fwd"):
        # x, w, y, BD, H, W, Cin, Cout, stream
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
    else:  # x, dy, part, dw, BD, H, W, Cin, Cout, splits, stream
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def kernel_attrs(variant: str, cout: int, dw: bool = False) -> dict:
    """Registers, static and dynamic shared memory and local (spill) bytes
    per thread of the bf16 forward kernel ``variant`` at ``cout``, or with
    ``dw`` of the dw kernel (wide and fold are one template instance per
    Cout; the wide dw kernel's ring, and so its shared memory, is given at
    the main path's Cin of 144)."""
    fn = load_library("packed_conv").packed_conv_kernel_attrs
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    which = ("generic", "wide", "fold").index(variant) + 3 * dw
    _raise_on(fn(which, cout, 144, out),
              f"packed_conv_kernel_attrs({variant}, {cout}, dw={dw})")
    return dict(zip(("registers", "static_smem", "local_bytes",
                     "dynamic_smem"), out))


@functools.cache
def _dw_wide_fits(cin: int, cout: int) -> bool:
    fn = load_library("packed_conv").packed_conv_dw_wide_fits
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return bool(fn(cin, cout))


@functools.cache
def _dw_splits():
    fn = load_library("packed_conv").packed_conv_dw_splits
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    return fn


def _debug_wgmma_mn(a: torch.Tensor, b: torch.Tensor, swa: int, swb: int,
                    swap: bool = False, rs: bool = False) -> torch.Tensor:
    """One m64n96k16 wgmma of MN-major operands on the card: a [16, 64] and
    b [16, 96] bf16 -> a^T b [64, 96] f32, each staged in the swizzle of
    ``swa`` / ``swb`` bytes (0, 32 or 64) and described by
    ``hopper::desc_mn`` (with its two offsets exchanged where ``swap``); A
    from registers where ``rs``. It pins the descriptor conventions of
    ``csrc/hopper.cuh`` that the dw kernels rely on."""
    d = torch.empty((64, 96), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        _raise_on(_kernel("packed_conv_debug_wgmma_mn")(
            a.contiguous().data_ptr(), b.contiguous().data_ptr(),
            d.data_ptr(), swa, swb, int(swap), int(rs),
            torch.cuda.current_stream().cuda_stream), "debug_wgmma_mn")
    return d


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


def _launch_conv(x: torch.Tensor, w: torch.Tensor,
                 variant: str | None = None) -> torch.Tensor:
    """The forward kernel on contiguous CUDA tensors: the one ``_variant``
    picks, or ``variant`` where it is "generic", which takes every bf16
    shape (the on-card timing of the wgmma kernels against it). Counts the
    launch in ``variant_launches``, not in any wrapper's count."""
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("packed_conv wants contiguous operands")
    BD, H, W, Cin = x.shape
    Cout = w.shape[-1]
    y = torch.empty((BD, H, W, Cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    picked = _variant(x, w)
    if variant is not None and variant != picked and not (
            variant == "generic" and picked != "fma"):
        raise ValueError(f"packed_conv: the {variant} kernel does not take "
                         f"x {tuple(x.shape)} {x.dtype} and Cout {Cout}")
    variant = variant or picked
    wk = _RELAYOUT[variant](w) if variant in _RELAYOUT else w
    with torch.cuda.device(x.device):
        _raise_on(_kernel(_FWD_SYMBOL[variant])(
            x.data_ptr(), wk.data_ptr(), y.data_ptr(), BD, H, W, Cin, Cout,
            torch.cuda.current_stream().cuda_stream),
            f"packed_conv ({variant})")
    variant_launches[variant] += 1
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
    dw = _launch_dw(xh, dy)
    packed_conv_dw.launches += 1
    return dw


def _launch_dw(x: torch.Tensor, dy: torch.Tensor,
               variant: str | None = None) -> torch.Tensor:
    """The dw kernels on contiguous CUDA tensors: the one ``_dw_variant``
    picks, or ``variant`` where it is "generic", which takes every bf16
    shape (the on-card timing of the wgmma kernels against it). Counts the
    launch in ``dw_variant_launches``, not in the wrapper's count."""
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("packed_conv_dw wants contiguous xh and dy")
    BD, H, W, Cin = x.shape
    Cout = dy.shape[-1]
    dw = torch.zeros((3, 3, Cin, Cout), dtype=torch.float32,
                     device=x.device)
    if x.numel() == 0 or dw.numel() == 0:
        return dw
    picked = _dw_variant(x, dy)
    if variant is not None and variant != picked and not (
            variant == "generic" and picked != "fma"):
        raise ValueError(f"packed_conv_dw: the {variant} kernel does not "
                         f"take x {tuple(x.shape)} {x.dtype} and Cout {Cout}")
    variant = variant or picked
    with torch.cuda.device(x.device):
        splits = _dw_splits()(BD, H, W, Cin, Cout, list(_DW_SYMBOL)
                              .index(variant))
        part = torch.empty((splits, 3, 3, Cin, Cout), dtype=torch.float32,
                           device=x.device)
        _raise_on(_kernel(_DW_SYMBOL[variant])(
            x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
            BD, H, W, Cin, Cout, splits,
            torch.cuda.current_stream().cuda_stream),
            f"packed_conv_dw ({variant})")
    dw_variant_launches[variant] += 1
    return dw


packed_conv.launches = 0
packed_conv_dx.launches = 0
packed_conv_dw.launches = 0
