"""The host side of the band conv's forward kernels, on the CPU: which
kernel each shape takes (``_variant``), and the weight re-layouts the wide
and folded-tap kernels read, each consumed as those kernels consume it (a
plain f32 GEMM per chunk and tap, or over the folded K) and held against
``packed_conv_reference`` on the same seeded inputs.

Tolerance: f32 sums of the same products in another order, 1e-5.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu_torch.ops.kernels.packed_conv import (
    FOLD_K, _fold_weight, _variant, _wide_weight, packed_conv_reference)

# the band convs of every main path (chip_smoke.py's CONV_SHAPES), dx of the
# second one (dy [.., 96] against the flipped band [3, 3, 96, 144]) and
# conv2d_3x3's shape
MAIN_PATH = [
    ((64, 256, 128, 6), 96, "fold"), ((64, 256, 128, 144), 96, "wide"),
    ((128, 256, 128, 6), 96, "fold"), ((128, 256, 128, 144), 96, "wide"),
    ((40, 160, 256, 6), 96, "fold"), ((40, 160, 256, 144), 96, "wide"),
    ((80, 160, 256, 6), 96, "fold"), ((80, 160, 256, 144), 96, "wide"),
    ((128, 256, 128, 96), 144, "wide"), ((80, 160, 256, 96), 144, "wide"),
    ((8, 128, 128, 64), 64, "wide"),
]
GENERIC = [
    ((3, 13, 70, 10), 40),    # Cin neither a multiple of 8 nor foldable
    ((2, 5, 33, 24), 100),    # Cout not a multiple of 8
    ((2, 8, 16, 144), 128),   # Cout without a wgmma instance
    ((2, 8, 18, 6), 96),      # W * Cin % 8 != 0: rows not 16-byte aligned
    ((2, 8, 16, 3), 96),      # odd Cin
    ((2, 8, 16, 12), 96),     # Cin above 8, not a multiple of 8
]


def _shaped(shape, dtype=torch.bfloat16):
    """A tensor of ``shape`` backed by one element (no memory)."""
    return torch.zeros(1, dtype=dtype).reshape([1] * len(shape)).expand(shape)


@pytest.mark.parametrize("shape,cout,want", MAIN_PATH)
def test_variant_main_path(shape, cout, want):
    x = _shaped(shape)
    assert _variant(x, _shaped((3, 3, shape[-1], cout))) == want


@pytest.mark.parametrize("shape,cout", GENERIC)
def test_variant_generic(shape, cout):
    assert _variant(_shaped(shape), _shaped((3, 3, shape[-1], cout))) \
        == "generic"


def test_variant_unaligned_and_f32():
    x = torch.zeros(2 * 8 * 16 * 144 + 1, dtype=torch.bfloat16)[1:]
    x = x.reshape(2, 8, 16, 144)   # 2 bytes past an aligned start
    w = _shaped((3, 3, 144, 96))
    assert _variant(x, w) == "generic"
    assert _variant(_shaped((2, 8, 16, 144), torch.float32),
                    _shaped((3, 3, 144, 96), torch.float32)) == "fma"


def _inputs(shape, cout, seed):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    x = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(3, 3, cin, cout)) / (9 * cin) ** 0.5,
                        dtype=torch.float32)
    return x, w


def _shifted(x, kh, kw):
    """x[bd, h + kh - 1, w + kw - 1, :], zero outside the image."""
    _, H, W, _ = x.shape
    return F.pad(x, (0, 0, 1, 1, 1, 1))[:, kh:kh + H, kw:kw + W]


@pytest.mark.parametrize("shape,cout", [
    ((2, 5, 7, 144), 96), ((1, 4, 9, 96), 144), ((2, 3, 5, 64), 64),
    ((1, 3, 6, 24), 96),      # a last chunk of 8 channels: zero rows
])
def test_wide_weight_as_the_kernel_reads_it(shape, cout):
    x, w = _inputs(shape, cout, 0)
    cin = shape[-1]
    wk = _wide_weight(w)
    chunks = -(-cin // 16)
    assert tuple(wk.shape) == (chunks, 9, 2, cout, 8)
    xpad = F.pad(x, (0, 16 * chunks - cin))
    y = torch.zeros((*shape[:3], cout))
    for c in range(chunks):
        for tap in range(9):
            a = _shifted(xpad[..., 16 * c:16 * c + 16], tap // 3, tap % 3)
            # B[k = 8 h + j, n] = wk[c, tap, h, n, j]
            b = wk[c, tap].permute(0, 2, 1).reshape(16, cout)
            y += a @ b
    torch.testing.assert_close(y, packed_conv_reference(x, w), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape,cout", [
    ((2, 5, 8, 6), 96), ((1, 3, 4, 2), 64), ((1, 4, 6, 4), 144),
])
def test_fold_weight_as_the_kernel_reads_it(shape, cout):
    x, w = _inputs(shape, cout, 1)
    cin = shape[-1]
    wf = _fold_weight(w)
    assert tuple(wf.shape) == (FOLD_K // 8, cout, 8)
    # A[p, k = tap * Cin + ci] = x[h + kh - 1, w + kw - 1, ci], zero past 9 Cin
    a = torch.cat([_shifted(x, tap // 3, tap % 3) for tap in range(9)], -1)
    a = F.pad(a, (0, FOLD_K - 9 * cin))
    b = wf.permute(0, 2, 1).reshape(FOLD_K, cout)   # B[8 g + j, n]
    assert torch.count_nonzero(b[9 * cin:]) == 0
    torch.testing.assert_close(a @ b, packed_conv_reference(x, w), rtol=1e-5,
                               atol=1e-5)
