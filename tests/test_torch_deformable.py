"""The port's deformable attention against the JAX package at f32:
``ms_deform_attn`` (forward 1e-5, value / location / weight gradients
1e-4 rel-L2, out-of-bounds samples and non-cubic levels), ``MSDeformAttn``
and ``DecoderDefAttnBlock`` (1e-5, weights bridged), the directional
offset init, and the whole tiny model with the deformable FPN refine
(``use_decoder_attn``: logits 2e-4, boxes 2e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_config
from tests.torch_parity import (apply, forward_pair, init_params, load,
                                model_pair, t)
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.models import def_attn as jdef
from transoar_tpu.ops.deformable_attention import ms_deform_attn as jms
from transoar_tpu_torch.models import def_attn
from transoar_tpu_torch.ops.deformable_attention import ms_deform_attn
from transoar_tpu_torch.utils import weights

# non-cubic levels, odd sizes
SHAPES = ((4, 5, 3), (2, 3, 2), (1, 2, 2))


def _case(seed, B=2, Q=6, M=2, D=4, P=3, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    L = len(shapes)
    S = sum(int(np.prod(s)) for s in shapes)
    value = rng.normal(size=(B, S, M, D)).astype(np.float32)
    # a tenth of the samples outside [0, 1] on some axis: zero padding
    loc = rng.uniform(-0.15, 1.15, size=(B, Q, M, L, P, 3)).astype(np.float32)
    w = rng.uniform(size=(B, Q, M, L, P)).astype(np.float32)
    w /= w.sum(axis=(3, 4), keepdims=True)
    return value, loc, w


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_case_samples_out_of_bounds():
    _, loc, _ = _case(0)
    outside = ((loc < 0) | (loc > 1)).any(-1)
    assert 0.1 < outside.mean() < 0.9


@pytest.mark.parametrize("D", [1, 4, 16])
def test_ms_deform_attn_forward_matches_jax(D):
    value, loc, w = _case(D, D=D)
    ref = np.asarray(jms(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                         jnp.asarray(w)))
    ours = ms_deform_attn(t(value), SHAPES, t(loc), t(w))
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


def test_ms_deform_attn_gradients_match_jax():
    value, loc, w = _case(7, B=1, Q=5, M=2, D=3, P=2)
    cot = np.random.default_rng(8).normal(size=(1, 5, 6)).astype(np.float32)

    def loss(v, l, wt):
        return (jms(v, SHAPES, l, wt) * cot).sum()

    refs = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(w))
    ins = [t(a).requires_grad_() for a in (value, loc, w)]
    (ms_deform_attn(ins[0], SHAPES, ins[1], ins[2]) * t(cot)).sum() \
        .backward()
    for name, x, ref in zip(("value", "locations", "weights"), ins, refs):
        assert _rel(x.grad.numpy(), ref) < 1e-4, name


def test_ms_deform_attn_bf16_value_rounds_as_jax():
    """A bf16 value is widened exactly and the sums run in f32, as the
    JAX gathers of bf16 values against f32 corner weights."""
    value, loc, w = _case(3)
    vb = jnp.asarray(value).astype(jnp.bfloat16)
    ref = jms(vb, SHAPES, jnp.asarray(loc), jnp.asarray(w).astype(
        jnp.bfloat16))
    assert ref.dtype == jnp.float32
    ours = ms_deform_attn(t(value).bfloat16(), SHAPES, t(loc),
                          t(w).bfloat16())
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("heads", [6, 26])
def test_directional_offset_bias(heads):
    bias = def_attn.directional_offset_bias(heads, 3, 4)
    np.testing.assert_array_equal(bias, jdef.directional_offset_bias(
        heads, 3, 4))
    grid = bias.reshape(heads, 3, 4, 3)
    # point i steps i + 1 along its head's direction, on every level
    np.testing.assert_array_equal(grid[:, :, 3], 4 * grid[:, :, 0])
    assert len({tuple(d) for d in grid[:, 0, 0]}) == heads


def test_models_start_from_the_directional_init():
    """build_model's init leaves every MSDeformAttn (the refine's and
    Deformable DETR's) with the directional bias and zero kernels."""
    from transoar_tpu_torch.models.transoarnet import build_model
    from transoar_tpu_torch.presets import tiny_config as port_tiny

    for family in ("refine", "def_detr"):
        model = build_model(port_tiny(family))
        layers = [m for m in model.modules()
                  if isinstance(m, def_attn.MSDeformAttn)]
        assert len(layers) == (2 if family == "refine" else 3)
        for layer in layers:
            want = def_attn.directional_offset_bias(
                layer.n_heads, layer.n_levels, layer.n_points)
            np.testing.assert_array_equal(
                layer.sampling_offsets.bias.detach().numpy(), want)
            assert not layer.sampling_offsets.weight.any()
            assert not layer.attention_weights.weight.any()
            assert not layer.attention_weights.bias.any()


def test_directional_init_needs_6_or_26_heads():
    with pytest.raises(ValueError, match="6 or 26"):
        def_attn.MSDeformAttn(16, 2, 4, 2)


def test_reference_points_match_jax():
    np.testing.assert_array_equal(def_attn.reference_points(SHAPES),
                                  jdef.reference_points(SHAPES))


def test_msdeformattn_matches_jax():
    rng = np.random.default_rng(11)
    B, Q, C = 2, 7, 24
    S = sum(int(np.prod(s)) for s in SHAPES)
    query = rng.normal(size=(B, Q, C)).astype(np.float32)
    src = rng.normal(size=(B, S, C)).astype(np.float32)
    ref = rng.uniform(0, 1, size=(B, Q, len(SHAPES), 3)).astype(np.float32)
    jmod = jdef.MSDeformAttn(C, len(SHAPES), 6, 2, dtype=jnp.float32)
    params = init_params(jmod, query, ref, src, SHAPES, seed=2)
    # spatial_shapes are static: no jit
    want = jmod.apply({"params": params}, query, ref, src, SHAPES)
    port = load(def_attn.MSDeformAttn(C, len(SHAPES), 6, 2,
                                      dtype=torch.float32),
                weights.to_torch(weights.ms_deform_attn(params)))
    with torch.inference_mode():
        got = port(t(query), t(ref), t(src), SHAPES)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_refine_block_matches_jax():
    rng = np.random.default_rng(12)
    C, levels = 24, ((4, 4, 2), (2, 2, 1))
    fmaps = [rng.normal(size=(2, *s, C)).astype(np.float32) for s in levels]
    jmod = jdef.DecoderDefAttnBlock(C, 6, 2, 32, 0.0, 2, dtype=jnp.float32)
    params = init_params(jmod, fmaps, seed=3)
    want = apply(jmod, params, fmaps)
    port = load(def_attn.DecoderDefAttnBlock(C, 6, 2, 32, 0.0, 2, 2,
                                             dtype=torch.float32),
                weights.to_torch(weights.refine(params)))
    with torch.inference_mode():
        got = port([t(f) for f in fmaps])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_refine_model_matches_jax():
    """The tiny flagship with the deformable refine over P2-P3 (the
    refined P2 feeds the Focused Decoder)."""
    cfg = tiny_config(precision="float32")
    cfg["backbone"]["use_decoder_attn"] = True
    x = np.random.default_rng(4).normal(
        size=(1, *cfg["augmentation"]["patch_size"], 1)).astype(np.float32)
    jmodel, params, port = model_pair(cfg, x, seed=5)
    assert "refine" in params["backbone"]["decoder"]
    ref, ours = forward_pair(jmodel, params, port, x)
    assert set(ours) == set(ref)
    for key in ref:
        tol = 2e-4 if "logits" in key else 2e-5
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=tol,
                                   err_msg=key)
    assert np.ptp(ours["pred_logits"]) > 1e-2
