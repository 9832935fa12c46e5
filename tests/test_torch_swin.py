"""The port's Swin modules (transoar_tpu_torch/models/swin.py) against the
JAX package's, with the same seeded weights bridged by utils/weights.py:
SwinBlock (shift off and on, through the JAX flat-window path),
PatchMerging, ConvPatchMerging and EncoderSwinBlock, forward and parameter gradients, in f32
and in eval mode (no DropPath). Tolerances: the two LayerNorms differ in
their variance formula (one-pass in JAX, two-pass in torch), which leaves
f32 rounding-level differences: forward atol 2e-5, gradients rel-L2 1e-4.
Plus the device caches, the clamped window's table, and DropPath's rate,
per-sample broadcast, scaling and eval-mode identity."""

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import init_params, load
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.models import swin as jswin
from transoar_tpu_torch.models import swin
from transoar_tpu_torch.models.layers import drop_path
from transoar_tpu_torch.utils import weights


def _grads(module, params, x):
    """JAX: forward and d(sum(out^2))/d(params, x)."""
    def loss(p, v):
        return (module.apply({"params": p}, v) ** 2).sum()
    out = module.apply({"params": params}, x)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    return np.asarray(out), jax.tree.map(np.asarray, gp), np.asarray(gx)


def _compare(port, jmodule, params, to_sd, x, call=None, floor=0.0):
    """Forward atol 2e-5, every gradient within rel-L2 1e-4; a parameter
    whose gradient is below ``floor`` times the largest one's norm (zero in
    theory, float noise in both) must stay that small on both sides."""
    out, gp, gx = _grads(jmodule, params, x)
    load(port, to_sd(params))
    xt = torch.tensor(x, requires_grad=True)
    ours = port(xt) if call is None else call(port, xt)
    (ours ** 2).sum().backward()
    np.testing.assert_allclose(ours.detach().numpy(), out, atol=2e-5)
    ref = weights.to_torch(to_sd(gp))
    grads = dict(port.named_parameters())
    assert set(grads) == set(ref)
    largest = max(float(g.norm()) for g in ref.values())
    for name, g in ref.items():
        if float(g.norm()) < floor * largest:
            assert float(grads[name].grad.norm()) < 10 * floor * largest
            continue
        rel = float((grads[name].grad - g).norm() / g.norm())
        assert rel < 1e-4, f"{name}: rel-L2 {rel:.2e}"
    rel = np.linalg.norm(xt.grad.numpy() - gx) / np.linalg.norm(gx)
    assert rel < 1e-4, rel


@pytest.mark.parametrize("shift", [False, True])
def test_swin_block_matches_jax(shift):
    rng = np.random.default_rng(int(shift))
    x = rng.normal(size=(2, 10, 10, 8, 16)).astype(np.float32)
    jblock = jswin.SwinBlock(dim=16, num_heads=2, window_size=(5, 5, 5),
                             shift=shift, blocked_attn=False,
                             dtype=jax.numpy.float32)
    params = init_params(jblock, x, seed=3)
    port = swin.SwinBlock(16, 2, (5, 5, 5), shift, dtype=torch.float32)
    _compare(port, jblock, params, weights.swin_block, x)


def test_patch_merging_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 5, 6, 3, 8)) \
        .astype(np.float32)
    jmerge = jswin.PatchMerging(dim=8, dtype=jax.numpy.float32)
    params = init_params(jmerge, x, seed=4)
    port = swin.PatchMerging(8, dtype=torch.float32)
    _compare(port, jmerge, params, weights.patch_merging, x)
    assert port(torch.from_numpy(x)).shape == (2, 3, 3, 2, 16)


def test_encoder_swin_block_matches_jax():
    """Two blocks (the second shifted) with a clamped depth axis (4 < 5:
    window 5x5x4, no shift along it), DropPath rates set but eval mode."""
    x = np.random.default_rng(3).normal(size=(1, 10, 10, 4, 16)) \
        .astype(np.float32)
    jstage = jswin.EncoderSwinBlock(depth=2, num_heads=2,
                                    window_size=(5, 5, 5),
                                    drop_path=(0.0, 0.3), blocked_attn=False,
                                    dtype=jax.numpy.float32)
    params = init_params(jstage, x, seed=5)
    port = swin.EncoderSwinBlock(16, 2, 2, (5, 5, 5), drop_path=(0.0, 0.3),
                                 dtype=torch.float32, spatial=(10, 10, 4))
    _compare(port, jstage, params, weights.swin_stage, x)


def test_conv_merging_matches_jax():
    """``swin.conv_merging``: ConvPatchMerging (2x2x2 stride-2 conv,
    InstanceNorm, ReLU) alone and as an EncoderSwinBlock's merge; odd sizes
    raise, as the JAX patch matmul asserts."""
    x = np.random.default_rng(6).normal(size=(2, 6, 4, 8, 8)) \
        .astype(np.float32)
    jmerge = jswin.ConvPatchMerging(dim=8, dtype=jax.numpy.float32)
    params = init_params(jmerge, x, seed=7)
    port = swin.ConvPatchMerging(8, dtype=torch.float32)
    _compare(port, jmerge, params, weights.patch_merging, x)
    assert port(torch.from_numpy(x)).shape == (2, 3, 2, 4, 16)
    with pytest.raises(ValueError, match="even"):
        port(torch.zeros(1, 5, 4, 4, 8))

    x = x[:1, :, :, :4]
    jstage = jswin.EncoderSwinBlock(depth=1, num_heads=2,
                                    window_size=(2, 2, 2), conv_merging=True,
                                    blocked_attn=False,
                                    dtype=jax.numpy.float32)
    params = init_params(jstage, x, seed=8)
    port = swin.EncoderSwinBlock(8, 1, 2, (2, 2, 2), conv_merging=True,
                                 dtype=torch.float32, spatial=(6, 4, 4))
    assert isinstance(port.downsample, swin.ConvPatchMerging)
    # the merge's InstanceNorm removes any per-channel constant, so the
    # gradient of the MLP's output bias is zero but for float noise
    _compare(port, jstage, params, weights.swin_stage, x, floor=1e-5)


def test_device_constants_are_cached():
    a = swin._regions((10, 10, 10), (5, 5, 5), (2, 2, 2),
                      torch.device("cpu"))
    assert a is swin._regions((10, 10, 10), (5, 5, 5), (2, 2, 2),
                              torch.device("cpu"))
    assert a.shape == (8, 125)
    zero = swin._regions((10, 10, 10), (5, 5, 5), (0, 0, 0),
                         torch.device("cpu"))
    assert zero.shape == (1, 125) and not zero.any()


def test_drop_path_rate_broadcast_and_scale():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(20000, 3, 2)
    y = drop_path(x, 0.3, gen)
    per_sample = y.flatten(1)
    # one draw per sample, broadcast over the other axes
    assert torch.all(per_sample == per_sample[:, :1])
    kept = per_sample[:, 0] != 0
    assert abs(1 - kept.float().mean().item() - 0.3) < 0.015
    torch.testing.assert_close(per_sample[kept, 0],
                               torch.full((int(kept.sum()),), 1 / 0.7))
    assert drop_path(x, 0.0, gen) is x


def test_window_clamped_to_the_input_sizes_the_bias_table():
    block = swin.SwinBlock(8, 2, (5, 5, 5), shift=True, spatial=(10, 10, 4))
    assert block.attn.relative_position_bias_table.shape == (9 * 9 * 7, 2)
    with pytest.raises(ValueError, match="built for a"):
        block(torch.zeros(1, 10, 10, 6, 8))


def test_drop_path_only_in_train_mode():
    block = swin.SwinBlock(8, 2, (2, 2, 2), shift=True, drop_path=0.5,
                           dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    for m in block.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    x = torch.randn(16, 4, 4, 4, 8, generator=gen)
    block.eval()
    base = block(x)
    block.drop_path = 0.0
    torch.testing.assert_close(block(x), base, rtol=0, atol=0)
    block.drop_path = 0.5
    block.train()
    a = block(x, torch.Generator().manual_seed(1))
    b = block(x, torch.Generator().manual_seed(2))
    assert not torch.allclose(a, b)
    # a sample whose both branches were dropped passes through unchanged
    same = [(a[i] == x[i]).all().item() for i in range(len(x))]
    assert any(same)
