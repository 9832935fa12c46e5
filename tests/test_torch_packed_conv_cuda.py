"""The packed band conv's CUDA kernels (forward, dx, dw) against their
plain versions, on the card.

This file imports no jax, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_packed_conv_cuda.py

Every test carries the ``cuda`` marker (registered in pytest.ini) and,
without a CUDA device, skips (decided inside the fixture).
The bf16 forward kernel has three variants chosen by shape (wide, fold,
generic), and so has the bf16 dw (wide, fold, generic); each case names
the one it must take and checks its count.
Tolerance: the kernel and the plain version both accumulate in f32; in f32
they differ only by summation order (1e-4), in bf16 by one rounding of the
output (rtol 1.6e-2, atol 1e-2: two bf16 ulps). dw is f32 whatever its
inputs: rel-L2 1e-5 against the plain version of the same inputs (sums of
up to a few thousand products in another order), and bit-identical when
run twice (a split reduction, no atomics).
"""

import pytest
import torch

from transoar_tpu_torch.ops.kernels import packed_conv as pc
from transoar_tpu_torch.ops.kernels.conv2d import (conv2d_3x3,
                                                   conv2d_3x3_reference)
from transoar_tpu_torch.ops.kernels.packed_conv import (
    packed_conv, packed_conv_dw, packed_conv_dw_reference, packed_conv_dx,
    packed_conv_dx_reference, packed_conv_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-4, 1e-4)),
                                       (torch.bfloat16, (1.6e-2, 1e-2))])
@pytest.mark.parametrize("shape,cout", [
    ((2, 8, 16, 6), 8),
    ((3, 13, 70, 10), 40),    # H, W and Cout not multiples of the tiles
    ((2, 5, 33, 24), 100),    # a half channel chunk; Cout % 8 != 0, > 96
    ((1, 9, 130, 144), 96),   # the second stage-0 conv's channels
])
def test_packed_conv_kernel_matches_plain(cuda, dtype, tol, shape, cout):
    gen = torch.Generator(device=cuda).manual_seed(0)
    cin = shape[-1]
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = (torch.randn((3, 3, cin, cout), generator=gen, device=cuda)
         / (9 * cin) ** 0.5).to(dtype)
    before = packed_conv.launches
    ours = packed_conv(x, w)
    torch.cuda.synchronize()
    assert packed_conv.launches == before + 1
    torch.testing.assert_close(ours, packed_conv_reference(x, w),
                               rtol=tol[0], atol=tol[1])


SHAPES = [
    ((2, 8, 16, 6), 8),
    ((3, 13, 70, 10), 40),    # H, W and Cout not multiples of the tiles
    ((2, 5, 33, 24), 100),    # Cout % 8 != 0 and > 96: two n tiles
    ((1, 9, 130, 144), 96),   # the second stage-0 conv's channels
    ((2, 6, 20, 6), 96),      # Cin = 6: 12-byte pixels, unaligned loads
]


def _operands(cuda, shape, cout, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    cin = shape[-1]
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = (torch.randn((3, 3, cin, cout), generator=gen, device=cuda)
         / (9 * cin) ** 0.5).to(dtype)
    dy = torch.randn((*shape[:3], cout), generator=gen,
                     device=cuda).to(dtype)
    return x, w, dy


@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-4, 1e-4)),
                                       (torch.bfloat16, (1.6e-2, 1e-2))])
@pytest.mark.parametrize("shape,cout", SHAPES)
def test_packed_conv_dx_kernel_matches_plain(cuda, dtype, tol, shape, cout):
    _, w, dy = _operands(cuda, shape, cout, dtype)
    before = packed_conv_dx.launches
    ours = packed_conv_dx(dy, w)
    torch.cuda.synchronize()
    assert packed_conv_dx.launches == before + 1
    assert ours.shape == shape and ours.dtype == dtype
    torch.testing.assert_close(ours, packed_conv_dx_reference(dy, w),
                               rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout", SHAPES)
def test_packed_conv_dw_kernel_matches_plain(cuda, dtype, shape, cout):
    x, _, dy = _operands(cuda, shape, cout, dtype)
    before = packed_conv_dw.launches
    ours = packed_conv_dw(x, dy)
    again = packed_conv_dw(x, dy)
    torch.cuda.synchronize()
    assert packed_conv_dw.launches == before + 2
    assert ours.dtype == torch.float32
    assert torch.equal(ours, again)  # deterministic
    ref = packed_conv_dw_reference(x, dy)
    rel = (ours - ref).norm() / ref.norm()
    assert rel < 1e-5, rel


def test_cuda_input_that_requires_grad_runs_backward(cuda):
    """Autograd through the kernels: dx and dw match the CPU's plain
    backward; a leaf without grad gets no dx launch."""
    x, w, dy = _operands(cuda, (2, 7, 40, 24), 32, torch.float32, seed=3)
    grads = {}
    for dev in ("cpu", "cuda"):
        xd = x.to(dev, copy=True).requires_grad_()
        wd = w.to(dev, copy=True).requires_grad_()
        counts = (packed_conv.launches, packed_conv_dx.launches,
                  packed_conv_dw.launches)
        packed_conv(xd, wd).backward(dy.to(dev))
        torch.cuda.synchronize()
        launched = (packed_conv.launches - counts[0],
                    packed_conv_dx.launches - counts[1],
                    packed_conv_dw.launches - counts[2])
        assert launched == ((1, 1, 1) if dev == "cuda" else (0, 0, 0))
        grads[dev] = (xd.grad.cpu(), wd.grad.cpu())
    for ours, ref in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(ours, ref, rtol=1e-4, atol=1e-4)
    wd = w.clone().requires_grad_()
    before = packed_conv_dx.launches
    packed_conv(x, wd).sum().backward()
    assert packed_conv_dx.launches == before and wd.grad is not None


def test_packed_conv_kernel_unaligned_operands(cuda):
    """Contiguous views that start 2 bytes past a 16-byte boundary take the
    element-by-element loads."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    shape, cout = (2, 6, 20, 16), 24
    n_x, n_w = 2 * 6 * 20 * 16, 3 * 3 * 16 * cout
    x = torch.randn(n_x + 1, generator=gen, device=cuda).bfloat16()[1:]
    w = (torch.randn(n_w + 1, generator=gen, device=cuda) / 12).bfloat16()[1:]
    x, w = x.view(shape), w.view(3, 3, 16, cout)
    assert x.data_ptr() % 16 and w.data_ptr() % 16
    torch.testing.assert_close(packed_conv(x, w), packed_conv_reference(x, w),
                               rtol=1.6e-2, atol=1e-2)


def _launch_counted(fn, want, *args):
    """fn(*args), checking that it launched the forward kernel once, as
    variant ``want``; the result twice must be the same bits."""
    before = dict(pc.variant_launches)
    ours = fn(*args)
    torch.cuda.synchronize()
    after = pc.variant_launches
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {want: 1}
    assert torch.equal(fn(*args), ours)  # no split-K, no atomics
    return ours


@pytest.mark.parametrize("shape,cout,variant", [
    ((1, 9, 130, 144), 96, "wide"),   # odd H; W not a multiple of 128
    ((2, 7, 100, 96), 144, "wide"),   # Cout 144 in one wgmma tile
    ((1, 5, 33, 24), 96, "wide"),     # a last chunk of 8 channels
    ((2, 3, 260, 64), 64, "wide"),    # three column tiles, odd H
    ((2, 9, 20, 6), 96, "fold"),      # odd H; W < one tile
    ((1, 5, 132, 4), 64, "fold"),     # a masked tail past 128 columns
    ((1, 3, 8, 2), 144, "fold"),
    ((2, 4, 18, 6), 96, "generic"),   # Cin = 6 with W % 4 != 0
    ((3, 13, 70, 10), 40, "generic"),
])
def test_forward_variants_match_plain(cuda, shape, cout, variant):
    x, w, _ = _operands(cuda, shape, cout, torch.bfloat16, seed=5)
    assert pc._variant(x, w) == variant
    ours = _launch_counted(packed_conv, variant, x, w)
    torch.testing.assert_close(ours, packed_conv_reference(x, w),
                               rtol=1.6e-2, atol=1e-2)


def test_dx_takes_one_wide_tile(cuda):
    """dx at 96 -> 144 (the second conv's input gradient): the wide kernel
    with all 144 output channels in one tile."""
    shape, cout = (2, 7, 140, 144), 96
    _, w, dy = _operands(cuda, shape, cout, torch.bfloat16, seed=6)
    ours = _launch_counted(packed_conv_dx, "wide", dy, w)
    torch.testing.assert_close(ours, packed_conv_dx_reference(dy, w),
                               rtol=1.6e-2, atol=1e-2)


def test_conv2d_3x3_takes_the_wide_kernel(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((2, 11, 140, 64), generator=gen, device=cuda).bfloat16()
    w = torch.randn((3, 3, 64, 64), generator=gen, device=cuda) / 24
    ours = _launch_counted(conv2d_3x3, "wide", x, w)
    torch.testing.assert_close(ours, conv2d_3x3_reference(x, w),
                               rtol=1.6e-2, atol=1e-2)


def test_generic_kernel_on_request(cuda):
    """The generic kernel takes the wide and fold shapes too (chip_smoke.py
    times it against them); the wide and fold kernels refuse the others."""
    for shape in ((1, 9, 130, 144), (2, 9, 20, 6)):
        x, w, _ = _operands(cuda, shape, 96, torch.bfloat16, seed=8)
        ours = _launch_counted(pc._launch_conv, "generic", x, w, "generic")
        torch.testing.assert_close(ours, packed_conv_reference(x, w),
                                   rtol=1.6e-2, atol=1e-2)
    x, w, _ = _operands(cuda, (2, 4, 18, 6), 96, torch.bfloat16)
    with pytest.raises(ValueError, match="fold kernel does not take"):
        pc._launch_conv(x, w, "fold")


def _dw_counted(want, x, dy, variant=None):
    """dw of (x, dy) through the wrapper (or ``_launch_dw`` forcing
    ``variant``), checking that it launched the dw kernel ``want`` once;
    the result twice must be the same bits."""
    run = ((lambda: pc._launch_dw(x, dy, variant)) if variant
           else (lambda: packed_conv_dw(x, dy)))
    before = dict(pc.dw_variant_launches)
    ours = run()
    torch.cuda.synchronize()
    after = pc.dw_variant_launches
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {want: 1}
    assert torch.equal(run(), ours)  # split partials, no atomics
    return ours


@pytest.mark.parametrize("shape,cout,variant", [
    ((1, 9, 130, 144), 96, "wide"),   # odd H; W not a multiple of 16
    ((2, 8, 256, 16), 64, "wide"),    # one slab of 48 rows
    ((2, 7, 100, 96), 144, "wide"),   # Cout 144: two slabs per warpgroup
    ((2, 5, 37, 208), 64, "wide"),    # 3 Cin = 624: 10 slabs, 2 groups
    ((1, 4, 40, 256), 96, "wide"),    # a ring of two stages
    ((1, 4, 40, 256), 144, "generic"),  # two ring stages do not fit
    ((2, 6, 20, 6), 96, "fold"),
    ((1, 5, 132, 4), 64, "fold"),     # a tail past 128 columns
    ((1, 3, 8, 2), 144, "fold"),
    ((3, 13, 70, 10), 40, "generic"),  # the ragged shape
    ((1, 5, 33, 24), 96, "generic"),  # Cin % 16 != 0
])
def test_dw_variants_match_plain(cuda, shape, cout, variant):
    x, _, dy = _operands(cuda, shape, cout, torch.bfloat16, seed=9)
    assert pc._dw_variant(x, dy) == variant
    ours = _dw_counted(variant, x, dy)
    ref = packed_conv_dw_reference(x, dy)
    rel = (ours - ref).norm() / ref.norm()
    assert ours.dtype == torch.float32 and rel < 1e-5, rel


def test_dw_wide_fits(cuda):
    """The wide dw kernel's own rule (two ring stages in shared memory),
    which ``_dw_variant`` asks for on the card: Cin up to 240 at Cout 144,
    272 at 96, 304 at 64; never a Cin off the 16-channel groups or a Cout
    with no instance."""
    fits = pc._dw_wide_fits
    for cout, most in ((144, 240), (96, 272), (64, 304)):
        assert fits(16, cout) and fits(most, cout)
        assert not fits(most + 16, cout)
    assert not fits(24, 96) and not fits(0, 96) and not fits(144, 128)


def test_dw_generic_kernel_on_request(cuda):
    """The generic dw kernel takes the wide and fold shapes too
    (chip_smoke.py times it against them); the fold kernel refuses the
    others."""
    for shape in ((1, 9, 130, 144), (2, 6, 20, 6)):
        x, _, dy = _operands(cuda, shape, 96, torch.bfloat16, seed=10)
        ours = _dw_counted("generic", x, dy, "generic")
        ref = packed_conv_dw_reference(x, dy)
        assert (ours - ref).norm() / ref.norm() < 1e-5
    x, _, dy = _operands(cuda, (2, 4, 18, 6), 96, torch.bfloat16)
    with pytest.raises(ValueError, match="fold kernel does not take"):
        pc._launch_dw(x, dy, "fold")


@pytest.mark.parametrize("swa,swb,rs", [
    (0, 0, False), (0, 0, True),      # no swizzle
    (32, 64, False), (32, 32, False),  # dw_wide: x in 32-byte, dy 64 / 32
    (0, 64, True), (0, 32, True),     # dw_fold: A in registers
])
def test_mn_major_wgmma_tile(cuda, swa, swb, rs):
    """One m64n96k16 wgmma of MN-major operands (the transposed forms the
    dw kernels use) against a CPU product; the descriptor with its two
    offsets exchanged must not pass, so the convention is pinned."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    a = torch.randn((16, 64), generator=gen, device=cuda).bfloat16()
    b = torch.randn((16, 96), generator=gen, device=cuda).bfloat16()
    want = a.float().cpu().T @ b.float().cpu()
    got = pc._debug_wgmma_mn(a, b, swa, swb, rs=rs)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)
    swapped = pc._debug_wgmma_mn(a, b, swa, swb, swap=True, rs=rs)
    assert (swapped.cpu() - want).abs().max() > 1.0
