"""Port parity of the shared building blocks (transoar_tpu_torch.models.layers)
against transoar_tpu.models.layers at f32, with the same seeded random
parameters bridged by transoar_tpu_torch.utils.weights.

Tolerance 2e-5: the same arithmetic summed in another order (the one-pass
InstanceNorm variance included, which both sides compute)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.torch_parity import apply, init_params, load, t
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.models import layers as jl
from transoar_tpu_torch.models import layers as tl
from transoar_tpu_torch.utils import weights as bridge

TOL = dict(atol=2e-5, rtol=2e-5)
F32 = torch.float32


@pytest.mark.parametrize("packs", [1, 4])
def test_instance_norm(rng, packs):
    x = rng.normal(1.0, 2.0, size=(2, 4, 3, 5, packs * 3)).astype(np.float32)
    jmod = jl.InstanceNorm(dtype=jnp.float32, packs=packs)
    p = init_params(jmod, x)
    ref = apply(jmod, p, x)
    port = load(tl.InstanceNorm(3, dtype=F32), bridge.norm(p))
    np.testing.assert_allclose(port(t(x), packs=packs).detach().numpy(),
                               np.asarray(ref), **TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_in_relu(rng, stride):
    x = rng.normal(size=(2, 8, 6, 6, 3)).astype(np.float32)
    jmod = jl.ConvInReLU(5, strides=(stride,) * 3, dtype=jnp.float32)
    p = init_params(jmod, x)
    ref = apply(jmod, p, x)
    port = load(tl.ConvInReLU(3, 5, 3, stride, dtype=F32),
                bridge.conv_in_relu(p))
    np.testing.assert_allclose(port(t(x)).detach().numpy(), np.asarray(ref),
                               **TOL)


@pytest.mark.parametrize("stride,pack", [((2, 2, 2), 0), ((1, 1, 1), 0),
                                         ((1, 1, 1), 4)])
def test_encoder_cnn_block(rng, monkeypatch, stride, pack):
    monkeypatch.setenv("TRANSOAR_PALLAS_CONV", "1")
    x = rng.normal(size=(2, 8, 6, 5, 2)).astype(np.float32)
    jmod = jl.EncoderCnnBlock(features=6, strides=stride, dtype=jnp.float32,
                              packed_chain=pack)
    p = init_params(jmod, x)
    with pltpu.force_tpu_interpret_mode():
        ref = apply(jmod, p, x)
    port = load(tl.EncoderCnnBlock(2, 6, 3, stride, pack=pack,
                                   dtype=F32),
                bridge.encoder_block(p))
    np.testing.assert_allclose(port(t(x)).detach().numpy(), np.asarray(ref),
                               **TOL)


def test_mlp(rng):
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    jmod = jl.MLP(hidden_dim=16, output_dim=6, num_layers=3,
                  dtype=jnp.float32)
    p = init_params(jmod, x)
    port = load(tl.MLP(12, 16, 6, 3, dtype=F32), bridge.mlp(p))
    np.testing.assert_allclose(port(t(x)).detach().numpy(),
                               np.asarray(apply(jmod, p, x)),
                               **TOL)


def test_ffn(rng):
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    jmod = jl.FFN(dim_feedforward=32, dropout=0.0, dtype=jnp.float32)
    p = init_params(jmod, x)
    port = load(tl.FFN(24, 32, dtype=F32), bridge.ffn(p))
    np.testing.assert_allclose(port(t(x)).detach().numpy(),
                               np.asarray(apply(jmod, p, x)),
                               **TOL)


def test_multi_head_self_attention(rng):
    q = rng.normal(size=(2, 7, 24)).astype(np.float32)
    v = rng.normal(size=(2, 7, 24)).astype(np.float32)
    jmod = jl.MultiHeadSelfAttention(num_heads=4, dtype=jnp.float32)
    p = init_params(jmod, q, q, v)
    port = load(tl.MultiHeadSelfAttention(24, 4, dtype=F32),
                bridge.self_attention(p))
    np.testing.assert_allclose(port(t(q), t(q), t(v)).detach().numpy(),
                               np.asarray(apply(jmod, p, q, q, v)),
                               **TOL)
