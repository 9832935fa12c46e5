"""Port parity: the packed band conv and the depth-packed chain
(transoar_tpu_torch.ops) against the JAX package, whose Pallas kernel runs
in interpret mode on the CPU. Inputs are made with numpy from a seed.

Tolerances: the pack/unpack reshapes are exact; the convs sum in another
order than the JAX side, 1e-4 at f32 (as tests/test_pallas_packed_conv.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.ops import conv3d as jconv
from transoar_tpu.ops.pallas import packed_conv as jpacked
from transoar_tpu_torch.ops import conv3d as tconv
from transoar_tpu_torch.ops.kernels.packed_conv import (packed_conv,
                                                        packed_conv_reference)


@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 8, 16, 6), 6, 8),      # H multiple of the TPU tile
    ((1, 4, 8, 3), 3, 5),       # tiny
    ((1, 6, 12, 6), 6, 24),     # Cin=6 as the first stage-0 conv, ragged H
])
def test_packed_conv_matches_pallas(rng, shape, cin, cout):
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(3, 3, cin, cout)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpacked.packed_conv(jnp.asarray(x), jnp.asarray(w)))
    before = packed_conv.launches
    ours = packed_conv(torch.from_numpy(x), torch.from_numpy(w))
    assert packed_conv.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_packed_conv_rejects_bad_input():
    x = torch.zeros(1, 4, 4, 6)
    with pytest.raises(ValueError):
        packed_conv(x, torch.zeros(3, 3, 5, 8))
    with pytest.raises(TypeError):
        packed_conv(x.half(), torch.zeros(3, 3, 6, 8).half())
    with pytest.raises(ValueError):
        packed_conv(x[0], torch.zeros(3, 3, 6, 8))


def test_pack_unpack_depth_exact(rng):
    x = rng.normal(size=(2, 8, 3, 5, 4)).astype(np.float32)
    ref = np.asarray(jconv.pack_depth(jnp.asarray(x), 4))
    ours = tconv.pack_depth(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(
        tconv.unpack_depth(ours, 4).numpy(),
        np.asarray(jconv.unpack_depth(jnp.asarray(ref), 4)))
    np.testing.assert_array_equal(tconv.unpack_depth(ours, 4).numpy(), x)


def test_packed_band_kernel_matches_jax(rng):
    w = rng.normal(size=(3, 3, 3, 5, 7)).astype(np.float32)
    ref = np.asarray(jconv._packed_band_kernel(jnp.asarray(w), 4,
                                               jnp.float32))
    ours = tconv._packed_band_kernel(torch.from_numpy(w), 4, torch.float32)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)


def test_conv3d_packed_chain_matches_jax_pallas(rng, monkeypatch):
    monkeypatch.setenv("TRANSOAR_PALLAS_CONV", "1")
    x = rng.normal(size=(2, 8, 6, 5, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 3, 4)).astype(np.float32)
    xp = jconv.pack_depth(jnp.asarray(x), 4)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jconv.conv3d_packed_chain(xp, jnp.asarray(w), 4))
    ours = tconv.conv3d_packed_chain(
        tconv.pack_depth(torch.from_numpy(x), 4), torch.from_numpy(w), 4)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)
    # and it is the plain 3D conv of the unpacked volume
    plain = torch.nn.functional.conv3d(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3),
        torch.from_numpy(w).permute(4, 3, 0, 1, 2), padding=1)
    np.testing.assert_allclose(
        tconv.unpack_depth(ours, 4).numpy(),
        plain.permute(0, 2, 3, 4, 1).numpy(), atol=1e-4)


def test_packed_conv_reference_keeps_dtype(rng):
    x = torch.from_numpy(rng.normal(size=(1, 5, 6, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 4, 3)).astype(np.float32))
    out = packed_conv_reference(x.bfloat16(), w.bfloat16())
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    np.testing.assert_allclose(out.float().numpy(),
                               packed_conv_reference(x, w).numpy(),
                               atol=0.1, rtol=2e-2)
