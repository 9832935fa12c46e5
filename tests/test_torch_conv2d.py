"""The NHWC 3x3 conv of the port (``ops/kernels/conv2d.py``; on the CPU its
plain version) against the JAX package's Pallas ``conv2d_3x3_pallas`` in
interpret mode, as tests/test_pallas_conv.py runs it: f32 within 1e-4
(sums of up to 9 x C products in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.ops.pallas.conv2d import conv2d_3x3_pallas
from transoar_tpu_torch.ops.kernels.conv2d import (conv2d_3x3,
                                                   conv2d_3x3_reference)


@pytest.mark.parametrize("shape,f", [((2, 16, 12, 8), 16),
                                     ((1, 8, 10, 3), 5)])
def test_conv2d_3x3_matches_pallas(shape, f):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, shape[-1], f)) / 3).astype(np.float32)
    ref = np.asarray(conv2d_3x3_pallas(jnp.asarray(x), jnp.asarray(w),
                                       tile_rows=4, interpret=True))
    before = conv2d_3x3.launches
    ours = conv2d_3x3(torch.from_numpy(x), torch.from_numpy(w))
    assert conv2d_3x3.launches == before  # the CPU runs the plain version
    assert ours.shape == (*shape[:3], f)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)
    # the weight is cast to x's dtype, as on the TPU
    xb = torch.from_numpy(x).bfloat16()
    torch.testing.assert_close(
        conv2d_3x3(xb, torch.from_numpy(w)),
        conv2d_3x3_reference(xb, torch.from_numpy(w).bfloat16()))


def test_conv2d_3x3_rejects_other_kernels():
    with pytest.raises(ValueError, match=r"\[3, 3, C, F\]"):
        conv2d_3x3(torch.zeros(1, 4, 4, 2), torch.zeros(5, 5, 2, 3))
