"""Port parity of the packed band conv's backward (kernels 2 and 3 of the
JAX package: dx by ``_conv_rows`` on the flipped band, dw by ``_dw_rows``)
against ``jax.vjp`` of the Pallas ``packed_conv`` in interpret mode, and of
the gradients through the whole depth-packed chain. Inputs are made with
numpy from a seed.

Tolerances: f32, the same sums in another order, 1e-4 (as the forward's
test); ``gradcheck`` in f64 at its defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from transoar_tpu.ops import conv3d as jconv
from transoar_tpu.ops.pallas import packed_conv as jpacked
from transoar_tpu_torch.ops import conv3d as tconv
from transoar_tpu_torch.ops.kernels import packed_conv as pc


def _jax_vjp(x, w, dy):
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jpacked.packed_conv, jnp.asarray(x), jnp.asarray(w))
        return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 8, 16, 6), 6, 8),      # H multiple of the TPU tile
    ((1, 4, 8, 3), 3, 5),       # tiny
    ((1, 6, 12, 6), 6, 24),     # Cin=6 as the first stage-0 conv, ragged H
])
def test_backward_matches_pallas_vjp(rng, shape, cin, cout):
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(3, 3, cin, cout)).astype(np.float32)
    dy = rng.normal(size=(*shape[:3], cout)).astype(np.float32)
    ref_dx, ref_dw = _jax_vjp(x, w, dy)

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    counts = (pc.packed_conv.launches, pc.packed_conv_dx.launches,
              pc.packed_conv_dw.launches)
    pc.packed_conv(xt, wt).backward(torch.from_numpy(dy))
    # the CPU runs the plain versions: no kernel launches
    assert counts == (pc.packed_conv.launches, pc.packed_conv_dx.launches,
                      pc.packed_conv_dw.launches)
    np.testing.assert_allclose(xt.grad.numpy(), ref_dx, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), ref_dw, atol=1e-4, rtol=1e-4)
    # the plain versions called directly are the same functions
    np.testing.assert_allclose(
        pc.packed_conv_dx(torch.from_numpy(dy), torch.from_numpy(w)).numpy(),
        ref_dx, atol=1e-4, rtol=1e-4)
    dw = pc.packed_conv_dw(torch.from_numpy(x), torch.from_numpy(dy))
    assert dw.dtype == torch.float32
    np.testing.assert_allclose(dw.numpy(), ref_dw, atol=1e-4, rtol=1e-4)


def test_only_needed_gradients(rng):
    """An input without grad (the image side of the first conv) gets no dx:
    the backward computes dw alone."""
    x = torch.from_numpy(rng.normal(size=(1, 5, 6, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 4, 3)).astype(np.float32))
    w.requires_grad_()
    calls = []

    def spy(fn):
        def wrapped(*args):
            calls.append(fn.__name__)
            return fn(*args)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pc, "packed_conv_dx", spy(pc.packed_conv_dx))
        mp.setattr(pc, "packed_conv_dw", spy(pc.packed_conv_dw))
        pc.packed_conv(x, w).sum().backward()
    assert calls == ["packed_conv_dw"] and x.grad is None
    assert w.grad.shape == w.shape


@pytest.mark.parametrize("fn,args", [
    ("packed_conv", ((2, 5, 7, 6), (3, 3, 6, 4))),
    ("chain", ((1, 4, 3, 5, 8), (3, 3, 3, 2, 3))),
])
def test_gradcheck_f64(fn, args):
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(args[0], dtype=torch.float64, generator=gen,
                    requires_grad=True)
    b = torch.randn(args[1], dtype=torch.float64, generator=gen,
                    requires_grad=True)
    f = pc.packed_conv if fn == "packed_conv" else \
        (lambda xp, w: tconv.conv3d_packed_chain(xp, w, 4))
    assert torch.autograd.gradcheck(f, (a, b))


def test_chain_gradients_match_jax(rng, monkeypatch):
    """Gradients through halo shifts, the band build and the band conv."""
    monkeypatch.setenv("TRANSOAR_PALLAS_CONV", "1")
    x = rng.normal(size=(2, 8, 6, 5, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 3, 4)).astype(np.float32)
    xp = np.array(jconv.pack_depth(jnp.asarray(x), 4))
    dy = rng.normal(size=(2, 2, 6, 5, 16)).astype(np.float32)

    def f(xp, w):
        return jconv.conv3d_packed_chain(xp, w, 4)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, jnp.asarray(xp), jnp.asarray(w))
        ref_dx, ref_dw = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    xt = torch.from_numpy(xp).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    tconv.conv3d_packed_chain(xt, wt, 4).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), ref_dx, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), ref_dw, atol=1e-4, rtol=1e-4)
