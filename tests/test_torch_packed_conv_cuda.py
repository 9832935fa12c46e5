"""The packed band conv's CUDA kernels (forward, dx, dw) against their
plain versions, on the card.

This file imports no jax, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_packed_conv_cuda.py

Every test carries the ``cuda`` marker (registered in pytest.ini) and,
without a CUDA device, skips (decided inside the fixture).
Tolerance: the kernel and the plain version both accumulate in f32; in f32
they differ only by summation order (1e-4), in bf16 by one rounding of the
output (rtol 1.6e-2, atol 1e-2: two bf16 ulps). dw is f32 whatever its
inputs: rel-L2 1e-5 against the plain version of the same inputs (sums of
up to a few thousand products in another order), and bit-identical when
run twice (a split reduction, no atomics).
"""

import pytest
import torch

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
