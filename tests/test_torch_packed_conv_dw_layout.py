"""The host side of the band conv's weight-gradient kernels, on the CPU:
which kernel each shape takes (``_dw_variant``), and the arithmetic the
wgmma kernels of ``csrc/packed_conv.cu`` build on, replayed here as plain
f32 GEMMs over their folded M and held against ``packed_conv_dw_reference``
on the same seeded inputs:

- ``dw_wide``: per tile of 8 x 16 dy pixels and per kw, the x patch rows
  h0 - 1 .. h0 + 8 of channels in 16-channel groups, read for dy row r as
  one [3 Cin, 16] operand (the patch rows r .. r + 2 flattened: M row m =
  kh Cin + ci), split into ceil(3 Cin / 64) m64 slabs; partials per split
  of contiguous tiles, flushed every 128 tiles, added in split order;
- ``dw_fold``: per tile of 2 x 128 dy pixels, the raw x rows at columns
  w0 - 8 .. w0 + 135, read as A [64, 128] with row m = tap Cin + ci (zero
  past 9 Cin) and pixel k at raw column k + kw + 7; one partial per
  (block, dy row), added in order.

Tolerance: f32 sums of the same products in another order (sums of up to
a few thousand terms of size ~1): rel-L2 1e-5, as the card's tests of the
kernels.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu_torch.ops.kernels.packed_conv import (
    _dw_variant, packed_conv_dw_reference)

# the tiles and the flush period of csrc/packed_conv.cu (DWW_TH x DWW_TW,
# DWF2_TH x DWF2_TW, DW_FLUSH)
WIDE_TILE, FOLD_TILE, FLUSH = (8, 16), (2, 128), 128

# x [BD, H, W, Cin] -> dy channels of each training path's dw (the first
# and second stage-0 convs of foc_dec_amos and swin_fpn_visceral)
MAIN_PATH = [
    ((128, 256, 128, 6), 96, "fold"), ((128, 256, 128, 144), 96, "wide"),
    ((80, 160, 256, 6), 96, "fold"), ((80, 160, 256, 144), 96, "wide"),
    ((1, 9, 130, 144), 96, "wide"), ((2, 8, 256, 16), 64, "wide"),
    ((2, 7, 100, 96), 144, "wide"), ((2, 6, 20, 6), 96, "fold"),
    ((1, 5, 132, 4), 64, "fold"), ((1, 3, 8, 2), 144, "fold"),
]
GENERIC = [
    ((3, 13, 70, 10), 40),    # the ragged shape: Cin 10, Cout 40
    ((2, 8, 16, 3), 96),      # odd Cin
    ((2, 5, 33, 32), 100),    # Cout not a multiple of 8
    ((2, 5, 33, 32), 128),    # Cout without a wgmma instance
    ((1, 5, 33, 24), 96),     # Cin % 8 == 0 but not a multiple of 16
    ((1, 4, 8, 12), 96),      # Cin 12: even, not a fold width, not % 16
    ((2, 8, 18, 6), 96),      # W * Cin % 8 != 0: rows not 16-byte aligned
]


def _shaped(shape, dtype=torch.bfloat16):
    """A tensor of ``shape`` backed by one element (no memory)."""
    return torch.zeros(1, dtype=dtype).reshape([1] * len(shape)).expand(shape)


@pytest.mark.parametrize("shape,cout,want", MAIN_PATH)
def test_dw_variant_main_path(shape, cout, want):
    assert _dw_variant(_shaped(shape), _shaped((*shape[:3], cout))) == want


@pytest.mark.parametrize("shape,cout", GENERIC)
def test_dw_variant_generic(shape, cout):
    assert _dw_variant(_shaped(shape), _shaped((*shape[:3], cout))) \
        == "generic"


def test_dw_variant_unaligned_and_f32():
    n = 2 * 8 * 16
    x = torch.zeros(n * 144 + 1, dtype=torch.bfloat16)[1:].reshape(2, 8, 16,
                                                                   144)
    dy = torch.zeros(n * 96 + 1, dtype=torch.bfloat16)[1:].reshape(2, 8, 16,
                                                                  96)
    assert _dw_variant(x, _shaped((2, 8, 16, 96))) == "generic"
    assert _dw_variant(_shaped((2, 8, 16, 144)), dy) == "generic"
    assert _dw_variant(_shaped((2, 8, 16, 144), torch.float32),
                       _shaped((2, 8, 16, 96), torch.float32)) == "fma"


def _inputs(shape, cout, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
    dy = torch.as_tensor(rng.normal(size=(*shape[:3], cout)),
                         dtype=torch.float32)
    return x, dy


def _assert_rel_l2(got, want, tol=1e-5):
    rel = ((got.double() - want.double()).norm() / want.double().norm())
    assert rel < tol, rel.item()


def _tiles(shape, tile):
    """The kernels' tile walk: t -> (bd, h0, w0), w fastest."""
    BD, H, W = shape[:3]
    th, tw = tile
    h_tiles, w_tiles = -(-H // th), -(-W // tw)
    for t in range(BD * h_tiles * w_tiles):
        r, wt = divmod(t, w_tiles)
        bd, ht = divmod(r, h_tiles)
        yield bd, ht * th, wt * tw


def _window(t, bd, h0, w0, rows, cols):
    """t[bd, h0:h0 + rows, w0:w0 + cols], zeros outside the image (what a
    TMA box of that size at those coordinates lands)."""
    _, H, W, C = t.shape
    out = torch.zeros((rows, cols, C))
    hs, ws = max(h0, 0), max(w0, 0)
    he, we = min(h0 + rows, H), min(w0 + cols, W)
    if hs < he and ws < we:
        out[hs - h0:he - h0, ws - w0:we - w0] = t[bd, hs:he, ws:we]
    return out


def _dw_wide_model(x, dy, splits, flush=FLUSH):
    """dw as dw_wide computes it (blocks of one kw, all slabs), the
    accumulators flushed every ``flush`` tiles."""
    cin, cout = x.shape[-1], dy.shape[-1]
    th, tw = WIDE_TILE
    slabs = -(-3 * cin // 64)
    tiles = list(_tiles(x.shape, WIDE_TILE))
    part = torch.zeros((splits, 3, 3, cin, cout))
    for split in range(splits):
        run = tiles[len(tiles) * split // splits:
                    len(tiles) * (split + 1) // splits]
        for kw in range(3):
            acc = torch.zeros((64 * slabs, cout))
            for i, (bd, h0, w0) in enumerate(run):
                # [rows][ci group][pixel][16] -> per row, M-major [Cin, tw]
                patch = _window(x, bd, h0 - 1, w0 + kw - 1, th + 2, tw)
                patch = patch.permute(0, 2, 1).reshape((th + 2) * cin, tw)
                patch = F.pad(patch, (0, 0, 0, 64 * slabs))  # slab overrun
                dyt = _window(dy, bd, h0, w0, th, tw)
                for r in range(th):
                    a = patch[r * cin:r * cin + 64 * slabs]  # m = kh Cin + ci
                    acc += a @ dyt[r]
                if (i + 1) % flush == 0 or i + 1 == len(run):
                    rows = acc[:3 * cin].reshape(3, cin, cout)
                    part[split, :, kw] += rows
                    acc.zero_()
    return part.sum(0)


def _dw_fold_model(x, dy, blocks):
    """dw as dw_fold computes it (A [64, 128] per dy row, built from the raw
    rows; one partial per block and dy row)."""
    cin, cout = x.shape[-1], dy.shape[-1]
    th, tw = FOLD_TILE
    tiles = list(_tiles(x.shape, FOLD_TILE))
    part = torch.zeros((2 * blocks, 64, cout))
    for b in range(blocks):
        for bd, h0, w0 in tiles[len(tiles) * b // blocks:
                                len(tiles) * (b + 1) // blocks]:
            raw = _window(x, bd, h0 - 1, w0 - 8, th + 2, tw + 16)
            dyt = _window(dy, bd, h0, w0, th, tw)
            for r in range(th):
                a = torch.zeros((64, tw))
                for tap in range(9):
                    kh, kw = divmod(tap, 3)
                    cols = raw[r + kh, kw + 7:kw + 7 + tw]   # [tw, Cin]
                    a[tap * cin:(tap + 1) * cin] = cols.T
                part[2 * b + r] += a @ dyt[r]
    return part.sum(0)[:9 * cin].reshape(3, 3, cin, cout)


@pytest.mark.parametrize("shape,cout,splits", [
    ((1, 9, 37, 48), 64, 3),     # odd H, ragged W; 3 Cin = 144: 3 slabs
    ((2, 8, 16, 16), 96, 2),     # Cin 16: one slab of 48 rows
    ((1, 17, 20, 32), 96, 1),    # 3 x 2 tiles in one split
])
def test_dw_wide_fold_of_kh_into_m(shape, cout, splits):
    x, dy = _inputs(shape, cout, 0)
    _assert_rel_l2(_dw_wide_model(x, dy, splits),
                   packed_conv_dw_reference(x, dy))


def test_dw_wide_flush_runs():
    """Several flush runs per split (a short period keeps the shape small):
    the first flush writes a slice and the later ones add to it."""
    x, dy = _inputs((1, 16, 64, 16), 64, 2)
    _assert_rel_l2(_dw_wide_model(x, dy, 2, flush=3),
                   packed_conv_dw_reference(x, dy))


def test_dw_wide_row_efficiency():
    """The rows dw_wide computes at the main path's Cin = 144, Cout = 96:
    the 3 Cin = 432 rows of the kh fold fill 7 m64 slabs; a block's two
    warpgroups hold S = 4 slots each and every slot runs its product for
    every dy row (a slot past the last slab repeats it), so 512 rows are
    computed and 432 used (84.4%), against 432 of 576 with 64-channel slabs
    per tap (3 taps x ceil(144 / 64) slabs). At Cout = 144 (S = 2) the 7
    slabs take two blocks' 8 slots: the same 512."""
    cin = 144
    slabs = -(-3 * cin // 64)
    for s in (4, 2):
        groups = -(-slabs // (2 * s))     # blocks per kw
        computed = 64 * 2 * s * groups
        assert (slabs, 3 * cin, computed) == (7, 432, 512)
    assert 3 * cin / computed == 0.84375
    assert 3 * -(-cin // 64) * 64 == 576


@pytest.mark.parametrize("shape,cout,blocks", [
    ((2, 5, 8, 6), 96, 2),       # odd H, W < one tile
    ((1, 3, 132, 4), 64, 1),     # a tail past 128 columns
    ((1, 4, 12, 2), 144, 3),
])
def test_dw_fold_of_taps_into_m(shape, cout, blocks):
    x, dy = _inputs(shape, cout, 1)
    _assert_rel_l2(_dw_fold_model(x, dy, blocks),
                   packed_conv_dw_reference(x, dy))
