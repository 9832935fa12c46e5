"""Port parity of the Focused Decoder neck and the sine position encoding
against transoar_tpu at f32 with the same seeded random parameters.

The numpy helpers copied from the JAX module must agree exactly; the sine
table too (both round the same float64 table to f32). The attention and the
decoder stack agree to 2e-5 (the same arithmetic in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import init_params, load, t
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.models import focused_decoder as jfd
from transoar_tpu.models.anchors import synthetic_bbox_props
from transoar_tpu.models.position_encoding import (
    sine_position_encoding as jax_sine)
from transoar_tpu_torch.models import focused_decoder as tfd
from transoar_tpu_torch.models.position_encoding import (
    PositionEmbeddingSine3D, sine_position_encoding)
from transoar_tpu_torch.utils import weights as bridge

TOL = dict(atol=2e-5, rtol=2e-5)
ORGANS, QPO, C, GRID = 3, 7, 24, (4, 4, 4)


@pytest.mark.parametrize("shape,channels", [((6, 5, 4), 24), ((3, 4, 5), 20)])
def test_sine_table_matches_jax(shape, channels):
    ref = np.asarray(jax_sine(shape, channels))
    np.testing.assert_array_equal(
        sine_position_encoding(shape, channels).astype(np.float32), ref)
    x = torch.zeros(2, *shape, channels)
    ours = PositionEmbeddingSine3D(channels, dtype=torch.float32)(x)
    assert ours.shape == (2, *shape, channels)
    np.testing.assert_array_equal(ours[1].numpy(), ref)


@pytest.mark.parametrize("restrict", [True, False])
def test_copied_numpy_helpers_exact(restrict):
    props = synthetic_bbox_props(4, seed=5)
    for patch, level in (([256, 256, 128], 3), ([32, 32, 16], 2)):
        assert tfd.level_spatial_shape(patch, level) == \
            jfd.level_spatial_shape(patch, level)
    bias = tfd.generate_attn_bias(props, (6, 5, 4), restrict=restrict)
    np.testing.assert_array_equal(
        bias, jfd.generate_attn_bias(props, (6, 5, 4), restrict=restrict))
    for pad in (128, 8):
        for ours, ref in zip(tfd.roi_token_indices(bias, pad),
                             jfd.roi_token_indices(bias, pad)):
            np.testing.assert_array_equal(ours, ref)
    assert tfd.MASKED_BIAS == jfd.MASKED_BIAS


def _neck_inputs(rng):
    props = synthetic_bbox_props(ORGANS, seed=3)
    bias = jfd.generate_attn_bias(props, GRID)
    roi = jfd.roi_token_indices(bias)
    return bias, roi


@pytest.mark.parametrize("use_roi", [True, False])
def test_focused_attention_both_paths(rng, use_roi):
    bias, roi = _neck_inputs(rng)
    S = int(np.prod(GRID))
    q = rng.normal(size=(2, ORGANS * QPO, C)).astype(np.float32)
    k = rng.normal(size=(2, S, C)).astype(np.float32)
    v = rng.normal(size=(2, S, C)).astype(np.float32)
    jroi = roi if use_roi else None
    jmod = jfd.FocusedAttn(num_heads=4, num_organs=ORGANS, dtype=jnp.float32)
    p = init_params(jmod, q, k, v, bias, roi=jroi)
    ref, _ = jmod.apply({"params": p}, q, k, v, bias, roi=jroi)
    port = load(tfd.FocusedAttn(C, 4, ORGANS, dtype=torch.float32),
                bridge.focused_attention(p))
    troi = (torch.from_numpy(roi[0]).long(), torch.from_numpy(roi[1])) \
        if use_roi else None
    ours = port(t(q), t(k), t(v), t(bias), troi)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("use_roi", [True, False])
def test_decoder_stack(rng, use_roi):
    bias, roi = _neck_inputs(rng)
    cfg = {"hidden_dim": C, "nheads": 4, "num_organs": ORGANS,
           "dim_feedforward": 32, "dec_layers": 2, "dropout": 0.0}
    src = rng.normal(size=(2, *GRID, C)).astype(np.float32)
    pos = rng.normal(size=(2, *GRID, C)).astype(np.float32)
    qe = rng.normal(size=(ORGANS * QPO, 2 * C)).astype(np.float32)
    jroi = roi if use_roi else None
    jmod = jfd.FocusedDecoder(cfg, attn_bias=bias, roi=jroi,
                              dtype=jnp.float32)
    p = init_params(jmod, src, qe, pos)
    ref, _ = jmod.apply({"params": p}, src, qe, pos)
    sd = {}
    for i in range(2):
        sd.update({f"decoder.layers.{i}.{k}": v for k, v in
                   bridge.decoder_layer(p[f"layer{i}"]).items()})
    port = load(tfd.FocusedDecoder(cfg, bias, jroi, dtype=torch.float32), sd)
    assert port.use_roi == use_roi
    ours = port(t(src), t(qe), t(pos))
    assert ours.shape == (2, 2, ORGANS * QPO, C)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **TOL)


def test_decoder_remat_dense_path(rng):
    """``neck.remat`` (the JAX default: on for the dense path) runs each
    layer under checkpoint: the dense path's gradients are the same with
    remat on and off, and match the JAX decoder's (which rematerialises);
    in training with dropout the recompute replays the forward's masks."""
    import jax

    bias, _ = _neck_inputs(rng)
    cfg = {"hidden_dim": C, "nheads": 4, "num_organs": ORGANS,
           "dim_feedforward": 32, "dec_layers": 2, "dropout": 0.0}
    src = rng.normal(size=(2, *GRID, C)).astype(np.float32)
    pos = rng.normal(size=(2, *GRID, C)).astype(np.float32)
    qe = rng.normal(size=(ORGANS * QPO, 2 * C)).astype(np.float32)
    jmod = jfd.FocusedDecoder(cfg, attn_bias=bias, roi=None,
                              dtype=jnp.float32)
    p = init_params(jmod, src, qe, pos)

    def loss(params, s):
        return jnp.square(jmod.apply({"params": params}, s, qe, pos)[0]).sum()

    jgrads, jsrc = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, src)
    sd, want = {}, {}
    for i in range(2):
        sd.update({f"decoder.layers.{i}.{k}": v for k, v in
                   bridge.decoder_layer(p[f"layer{i}"]).items()})
        want.update({f"decoder.layers.{i}.{k}": v for k, v in
                     bridge.decoder_layer(jax.tree.map(
                         np.asarray, jgrads[f"layer{i}"])).items()})
    runs = []
    for remat in (None, False):
        layer_cfg = cfg if remat is None else dict(cfg, remat=remat)
        port = load(tfd.FocusedDecoder(layer_cfg, bias, None,
                                       dtype=torch.float32), sd)
        assert port.remat == (remat is None)
        x = t(src).requires_grad_()
        port(x, t(qe), t(pos)).square().sum().backward()
        runs.append((x.grad, {n: q.grad for n, q in
                              port.named_parameters()}))
    (x1, g1), (x2, g2) = runs
    torch.testing.assert_close(x1, x2, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(x1.numpy(), np.asarray(jsrc), rtol=1e-4,
                               atol=1e-5)
    for name, grad in g2.items():
        torch.testing.assert_close(g1[name], grad, rtol=1e-6, atol=1e-7,
                                   msg=name)
        np.testing.assert_allclose(g1[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # training with dropout: the recompute draws the forward's masks
    drop = []
    for remat in (True, False):
        port = load(tfd.FocusedDecoder(dict(cfg, dropout=0.3, remat=remat),
                                       bias, None, dtype=torch.float32), sd)
        port.train()
        gen = torch.Generator().manual_seed(4)
        x = t(src).requires_grad_()
        out = port(x, t(qe), t(pos), gen)
        out.square().sum().backward()
        drop.append((out.detach(), x.grad, gen.get_state()))
    torch.testing.assert_close(drop[0][0], drop[1][0])
    torch.testing.assert_close(drop[0][1], drop[1][1])
    assert torch.equal(drop[0][2], drop[1][2])
