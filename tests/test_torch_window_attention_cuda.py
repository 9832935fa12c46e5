"""The fused window attention's CUDA kernels (forward and backward) and the
NHWC conv2d_3x3 on kernel 1's CUDA forward, against their plain versions,
on the card.

This file imports no jax, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_window_attention_cuda.py

Every test carries the ``cuda`` marker (registered in pytest.ini) and,
without a CUDA device, skips (decided inside the fixture).
Tolerances: the plain versions compute in f32 from the same inputs. The f32
kernels differ from them only in summation order (1e-5). The bf16 kernels
round the probabilities (and, in the backward, dS) to bf16 for the tensor
cores and the outputs to bf16: rtol 1.6e-2, atol 1e-2, two bf16 ulps. dbias
is f32 whatever the inputs, and its rows of P and dS stay f32 inside the
kernel: rel-L2 1e-4 against the plain version, and bit-identical when run
twice (a split reduction, no atomics). The same tolerances hold for every
bf16 variant: the wg kernels (d = 16, N <= 128: wgmma fed by a TMA ring),
the generic kernels they replaced on those shapes, and the one-tile check
of the wg kernels' wgmma forms (small integers: exact).
"""

import pytest
import torch

from transoar_tpu_torch.ops.kernels import window_attention as wa
from transoar_tpu_torch.ops.kernels._build import build_log
from transoar_tpu_torch.ops.kernels.conv2d import (conv2d_3x3,
                                                   conv2d_3x3_reference)
from transoar_tpu_torch.ops.kernels.window_attention import (
    fused_window_attention, fused_window_attention_bwd,
    window_attention_bwd_reference, window_attention_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(cuda, B, H, N, d, nW, dtype, seed=0, qkv_view=False):
    """q scaled by d^-0.5 as the Swin module scales it; bias N(0, 1)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    scale = torch.tensor([d ** -0.5, 1.0, 1.0], device=cuda)
    if qkv_view:  # views of a [B_, N, 3, H, d] projection, as the module
        qkv = torch.randn((B, N, 3, H, d), generator=gen, device=cuda)
        qkv = (qkv * scale[:, None, None]).to(dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    else:
        q, k, v = ((torch.randn((B, H, N, d), generator=gen, device=cuda)
                    * scale[i]).to(dtype) for i in range(3))
    bias = torch.randn((H, N, N), generator=gen, device=cuda)
    if nW == 1:
        region = torch.zeros((1, N), device=cuda)
    else:
        region = torch.randint(0, 4, (nW, N), generator=gen,
                               device=cuda).float()
    do = torch.randn((B, H, N, d), generator=gen, device=cuda).to(dtype)
    return q, k, v, bias, region, do


TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1.6e-2, 1e-2)}
SHAPES = [  # B_, H, N, d, nW
    (8, 3, 125, 16, 4),     # SwinFPN windows, shifted
    (6, 2, 125, 16, 1),     # unshifted
    (7, 3, 100, 8, 7),      # ragged N, d = 8, odd B_
    (5, 2, 13, 32, 1),      # small N, d = 32
    (4, 1, 128, 64, 2),     # the limits: N = 128, d = 64
    (3, 2, 100, 24, 3),     # d = 24: a zero-padded half k step
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_kernel_matches_plain(cuda, dtype, shape):
    q, k, v, bias, region, _ = _operands(cuda, *shape, dtype)
    before = fused_window_attention.launches
    ours = fused_window_attention(q, k, v, bias, region)
    torch.cuda.synchronize()
    assert fused_window_attention.launches == before + 1
    assert ours.shape == q.shape and ours.dtype == dtype
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(ours, window_attention_reference(
        q, k, v, bias, region), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_kernel_matches_plain(cuda, dtype, shape):
    q, k, v, bias, region, do = _operands(cuda, *shape, dtype, seed=1)
    before = fused_window_attention_bwd.launches
    ours = fused_window_attention_bwd(q, k, v, bias, region, do)
    again = fused_window_attention_bwd(q, k, v, bias, region, do)
    torch.cuda.synchronize()
    assert fused_window_attention_bwd.launches == before + 2
    ref = window_attention_bwd_reference(q, k, v, bias, region, do)
    rtol, atol = TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), ours[:3], ref[:3]):
        assert a.dtype == dtype, name
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                   msg=lambda m, name=name: f"{name}: {m}")
    assert ours[3].dtype == torch.float32
    rel = (ours[3] - ref[3]).norm() / ref[3].norm()
    assert rel < 1e-4, rel
    assert torch.equal(ours[3], again[3])  # deterministic


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_views_of_the_projection(cuda, dtype):
    """q, k, v as views of [B_, N, 3, H, d] and an output gradient laid out
    [B_, N, H, d] go to the kernels without a copy and give the same
    values."""
    q, k, v, bias, region, do = _operands(cuda, 8, 3, 125, 16, 4, dtype,
                                          seed=2, qkv_view=True)
    assert not q.is_contiguous() and q.stride(-1) == 1
    do = do.transpose(1, 2).contiguous().transpose(1, 2)
    rtol, atol = TOL[dtype]
    dense = [t.contiguous() for t in (q, k, v)]
    torch.testing.assert_close(
        fused_window_attention(q, k, v, bias, region),
        fused_window_attention(*dense, bias, region), rtol=0, atol=0)
    for a, b in zip(fused_window_attention_bwd(q, k, v, bias, region, do),
                    fused_window_attention_bwd(*dense, bias, region,
                                               do.contiguous())):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    out = fused_window_attention(q, k, v, bias, region)
    assert out.transpose(1, 2).is_contiguous()  # [B_, N, H, d] memory
    torch.testing.assert_close(out, window_attention_reference(
        q, k, v, bias, region), rtol=rtol, atol=atol)


def test_autograd_through_the_kernels(cuda):
    """Gradients of a loss through the autograd Function on the card match
    the CPU's plain backward; one launch of each kernel."""
    q, k, v, bias, region, _ = _operands(cuda, 6, 2, 64, 16, 3,
                                         torch.float32, seed=3)
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.to(dev, copy=True).requires_grad_()
                  for t in (q, k, v, bias)]
        counts = (fused_window_attention.launches,
                  fused_window_attention_bwd.launches)
        out = fused_window_attention(*leaves, region.to(dev))
        (out ** 2).sum().backward()
        torch.cuda.synchronize()
        launched = (fused_window_attention.launches - counts[0],
                    fused_window_attention_bwd.launches - counts[1])
        assert launched == ((1, 1) if dev == "cuda" else (0, 0))
        grads[dev] = [t.grad.cpu() for t in leaves]
    for ours, ref in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(ours, ref, rtol=1e-4, atol=1e-4)


def test_unsupported_shapes_raise(cuda):
    q, k, v, bias, region, _ = _operands(cuda, 2, 1, 13, 4, 1,
                                         torch.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_window_attention(q, k, v, bias, region)
    q, k, v, bias, region, _ = _operands(cuda, 2, 1, 130, 8, 1,
                                         torch.float32)
    with pytest.raises(ValueError, match="N <= 128"):
        fused_window_attention(q, k, v, bias, region)


WG_CASES = [  # B_, H, N, d, nW: shapes the wg kernels take
    (8, 3, 125, 16, 4),      # SwinFPN windows, shifted
    (6, 2, 125, 16, 1),      # unshifted
    (7, 3, 100, 16, 7),      # ragged N
    (1000, 3, 125, 16, 8),   # windows in runs that do not divide B_
    (32, 24, 125, 16, 16),   # stage 5: 768 window-heads
]


def _counts():
    return dict(wa.variant_launches), dict(wa.bwd_variant_launches)


def _launched(before):
    """The per-variant launches since ``before`` (forward, backward)."""
    return tuple({k: now[k] - was[k] for k in now if now[k] != was[k]}
                 for now, was in zip(_counts(), before))


def _check_grads(ours, again, ref):
    rtol, atol = TOL[torch.bfloat16]
    for name, a, b in zip(("dq", "dk", "dv"), ours[:3], ref[:3]):
        assert a.dtype == torch.bfloat16, name
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                   msg=lambda m, name=name: f"{name}: {m}")
    rel = (ours[3] - ref[3]).norm() / ref[3].norm()
    assert rel < 1e-4, rel
    assert torch.equal(ours[3], again[3])  # deterministic


@pytest.mark.parametrize("shape", WG_CASES)
def test_wg_kernels_match_plain(cuda, shape):
    """The wg kernels on q, k, v viewed from the projection: forward and
    backward against the plain versions, dbias the same bits twice, each
    launch counted under "wg"."""
    q, k, v, bias, region, do = _operands(cuda, *shape, torch.bfloat16,
                                          seed=5, qkv_view=True)
    assert wa._window_variant(q) == "wg"
    B, H = shape[:2]
    if B == 1000:  # the last block of each head takes a shorter run
        for bwd in (False, True):
            wpb, _ = wa._wg_split(B, H, wa._wg_target(
                torch.cuda.current_device(), bwd))
            assert B % wpb, wpb
    before = _counts()
    ours = fused_window_attention(q, k, v, bias, region)
    grads = fused_window_attention_bwd(q, k, v, bias, region, do)
    again = fused_window_attention_bwd(q, k, v, bias, region, do)
    torch.cuda.synchronize()
    assert _launched(before) == ({"wg": 1}, {"wg": 2})
    rtol, atol = TOL[torch.bfloat16]
    torch.testing.assert_close(ours, window_attention_reference(
        q, k, v, bias, region), rtol=rtol, atol=atol)
    _check_grads(grads, again, window_attention_bwd_reference(
        q, k, v, bias, region, do))


def test_forced_generic_matches_plain(cuda):
    """``variant="generic"`` runs the mma.sync kernels on a wg shape (how
    chip_smoke.py times them against the wg kernels): counted under
    "generic" and not in the wrappers' counts; a variant that does not take
    the shape raises."""
    q, k, v, bias, region, do = _operands(cuda, 8, 3, 125, 16, 4,
                                          torch.bfloat16, seed=6,
                                          qkv_view=True)
    before = _counts()
    wrappers = (fused_window_attention.launches,
                fused_window_attention_bwd.launches)
    ours = wa._launch_fwd(q, k, v, bias, region, "generic")
    grads = wa._launch_bwd(q, k, v, bias, region, do, "generic")
    again = wa._launch_bwd(q, k, v, bias, region, do, "generic")
    torch.cuda.synchronize()
    assert _launched(before) == ({"generic": 1}, {"generic": 2})
    assert wrappers == (fused_window_attention.launches,
                        fused_window_attention_bwd.launches)
    rtol, atol = TOL[torch.bfloat16]
    torch.testing.assert_close(ours, window_attention_reference(
        q, k, v, bias, region), rtol=rtol, atol=atol)
    _check_grads(grads, again, window_attention_bwd_reference(
        q, k, v, bias, region, do))
    f32 = [t.float() for t in (q, k, v)]
    with pytest.raises(ValueError, match="does not take"):
        wa._launch_fwd(*f32, bias, region, "wg")
    with pytest.raises(ValueError, match="does not take"):
        wa._launch_fwd(*f32, bias, region, "generic")


@pytest.mark.parametrize("dtype,d,want", [(torch.bfloat16, 16, "wg"),
                                          (torch.bfloat16, 8, "generic"),
                                          (torch.bfloat16, 32, "generic"),
                                          (torch.float32, 16, "fma")])
def test_variant_counts(cuda, dtype, d, want):
    """Each wrapper launch counts once, under the variant that ran."""
    q, k, v, bias, region, do = _operands(cuda, 4, 2, 50, d, 2, dtype,
                                          seed=7)
    before = _counts()
    fused_window_attention(q, k, v, bias, region)
    fused_window_attention_bwd(q, k, v, bias, region, do)
    torch.cuda.synchronize()
    assert _launched(before) == ({want: 1}, {want: 1})


def test_wgmma_tile(cuda):
    """One tile of each wgmma form of the wg kernels (Wgmma<128> with both
    operands K-major in the 32-byte swizzle; Wgmma<16> with A from
    registers, and with A MN-major from the staging layout) against CPU
    products; small integers, so every value is exact."""
    gen = torch.Generator().manual_seed(8)
    a, b, v = (torch.randint(-2, 3, shape, generator=gen).bfloat16()
               for shape in ((64, 16), (128, 16), (128, 16)))
    s, o, t = (x.cpu() for x in wa._debug_wgmma_tile(
        a.to(cuda), b.to(cuda), v.to(cuda)))
    ref = a.float() @ b.float().T
    p = ref.bfloat16().float()
    torch.testing.assert_close(s, ref, rtol=0, atol=0)
    torch.testing.assert_close(o, p @ v.float(), rtol=0, atol=0)
    torch.testing.assert_close(t, p.T @ a.float(), rtol=0, atol=0)


def test_wg_kernels_do_not_spill(cuda):
    """ptxas kept every value of the wg kernels in registers and issued
    their wgmmas without serialising them."""
    for name in ("fwd_wg", "bwd_wg"):
        attrs = wa.kernel_attrs(name)
        assert attrs["local_bytes"] == 0, (name, attrs)
    log = build_log("window_attention")
    assert not [line for line in log.splitlines()
                if any(c in line for c in ("C7512", "C7518", "C7520"))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,f", [((2, 16, 20, 8), 12),
                                     ((1, 9, 70, 32), 64)])
def test_conv2d_3x3_kernel_matches_plain(cuda, dtype, shape, f):
    gen = torch.Generator(device=cuda).manual_seed(4)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = torch.randn((3, 3, c, f), generator=gen, device=cuda) / (9 * c) ** .5
    before = conv2d_3x3.launches
    ours = conv2d_3x3(x, w)
    torch.cuda.synchronize()
    assert conv2d_3x3.launches == before + 1
    rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(ours, conv2d_3x3_reference(x, w), rtol=rtol,
                               atol=atol)
