"""The packed band conv's CUDA kernel against its plain version, on the card.

This file imports no jax, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_packed_conv_cuda.py

Every test carries the ``cuda`` marker (registered in pytest.ini) and,
without a CUDA device, skips (decided inside the fixture).
Tolerance: the kernel and the plain version both accumulate in f32; in f32
they differ only by summation order (1e-4), in bf16 by one rounding of the
output (rtol 1.6e-2, atol 1e-2: two bf16 ulps).
"""

import pytest
import torch

from transoar_tpu_torch.ops.kernels.packed_conv import (packed_conv,
                                                        packed_conv_reference)

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


def test_packed_conv_kernel_refuses_grad(cuda):
    x = torch.randn(1, 4, 4, 6, device=cuda, requires_grad=True)
    w = torch.randn(3, 3, 6, 8, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        packed_conv(x, w)


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
