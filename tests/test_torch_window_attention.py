"""The port's fused window attention on the CPU (plain version + autograd
Function) against the JAX package's Pallas kernel in interpret mode and its
XLA reference, as tests/test_swin.py runs them: forward within 2e-5, dq,
dk, dv and dbias within 5e-4 (that test's tolerances), on shifted (region
labels differ) and unshifted (one zero region) windows; plus an f64
``gradcheck`` of the autograd Function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.models.swin import shifted_window_regions
from transoar_tpu.ops.pallas.window_attention import \
    fused_window_attention as jfused
from transoar_tpu.ops.pallas.window_attention import \
    reference_window_attention as jreference
from transoar_tpu_torch.ops.kernels.window_attention import (
    fused_window_attention, fused_window_attention_bwd,
    window_attention_bwd_reference, window_attention_reference)


def _regions(kind, N, nW, rng):
    if kind == "unshifted":
        return np.zeros((1, N), np.float32)
    if kind == "random":
        return rng.integers(0, 3, size=(nW, N)).astype(np.float32)
    # the real cyclic-shift labels of a 5x10x10 volume: 4 windows of 125
    return shifted_window_regions((5, 10, 10), (5, 5, 5), (2, 2, 2))


CASES = [  # B_, H, N, d, regions
    (8, 3, 13, 4, "random"),
    (8, 3, 13, 4, "unshifted"),
    (8, 2, 125, 16, "shifted"),
    (4, 2, 125, 16, "unshifted"),
]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[2]}-{c[4]}")
def case(request):
    B, H, N, d, kind = request.param
    rng = np.random.default_rng(B * N + d)
    q, k, v = (rng.normal(size=(B, H, N, d)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(H, N, N)).astype(np.float32)
    region = _regions(kind, N, 4, rng)
    jargs = [jnp.asarray(a) for a in (q, k, v, bias)]
    jreg = jnp.asarray(region)
    ref = {"o": np.asarray(jreference(*jargs, jreg)),
           "o_pallas": np.asarray(jfused(*jargs, jreg))}
    grads = jax.grad(lambda *a: (jfused(*a, jreg) ** 2).sum(),
                     argnums=(0, 1, 2, 3))(*jargs)
    ref.update(zip(("dq", "dk", "dv", "dbias"), map(np.asarray, grads)))
    return (q, k, v, bias, region), ref


def test_forward_matches_jax(case):
    (q, k, v, bias, region), ref = case
    ours = fused_window_attention(*map(torch.from_numpy,
                                       (q, k, v, bias, region)))
    assert ours.shape == q.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref["o_pallas"], atol=2e-5)
    np.testing.assert_allclose(ours.numpy(), ref["o"], atol=2e-5)


def test_gradients_match_jax(case):
    (q, k, v, bias, region), ref = case
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    out = fused_window_attention(*leaves, torch.from_numpy(region))
    (out ** 2).sum().backward()
    for name, leaf in zip(("dq", "dk", "dv", "dbias"), leaves):
        assert leaf.grad.dtype == torch.float32
        np.testing.assert_allclose(leaf.grad.numpy(), ref[name], atol=5e-4,
                                   err_msg=name)
    # the backward's explicit entry point gives the same four
    do = 2 * out.detach()
    explicit = fused_window_attention_bwd(
        *(t.detach() for t in leaves), torch.from_numpy(region), do)
    for leaf, g in zip(leaves, explicit):
        torch.testing.assert_close(g, leaf.grad, rtol=1e-6, atol=1e-6)


def test_plain_versions_stay_off_the_kernel_counters(case):
    (q, k, v, bias, region), _ = case
    args = [torch.from_numpy(a) for a in (q, k, v, bias, region)]
    counts = (fused_window_attention.launches,
              fused_window_attention_bwd.launches)
    window_attention_reference(*args)
    fused_window_attention(*args)
    fused_window_attention_bwd(*args, args[0])
    assert (fused_window_attention.launches,
            fused_window_attention_bwd.launches) == counts


def test_gradcheck_f64():
    rng = np.random.default_rng(5)
    B, H, N, d, nW = 4, 2, 5, 2, 2
    q, k, v = (torch.tensor(rng.normal(size=(B, H, N, d)),
                            requires_grad=True) for _ in range(3))
    bias = torch.tensor(rng.normal(size=(H, N, N)), requires_grad=True)
    region = torch.tensor(rng.integers(0, 2, size=(nW, N)),
                          dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda *a: fused_window_attention(*a, region), (q, k, v, bias),
        fast_mode=True)


def test_bwd_reference_is_autograd_of_forward():
    rng = np.random.default_rng(6)
    B, H, N, d = 6, 2, 9, 4
    args = [torch.tensor(rng.normal(size=s), dtype=torch.float64,
                         requires_grad=True)
            for s in [(B, H, N, d)] * 3 + [(H, N, N)]]
    region = torch.tensor(rng.integers(0, 2, size=(3, N)),
                          dtype=torch.float64)
    do = torch.tensor(rng.normal(size=(B, H, N, d)))
    window_attention_reference(*args, region).backward(do)
    for got, leaf in zip(window_attention_bwd_reference(
            *(a.detach() for a in args), region, do), args):
        torch.testing.assert_close(got, leaf.grad, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("change,err", [
    (lambda a: a.update(bias=a["bias"][:, :-1]), ValueError),
    (lambda a: a.update(region=torch.zeros(3, 13)), ValueError),  # 3 !| 8
    (lambda a: a.update(k=a["k"].double()), TypeError),
    (lambda a: a.update(v=a["v"][:, :, :-1]), ValueError),
])
def test_bad_operands_raise(change, err):
    rng = np.random.default_rng(7)
    args = {n: torch.tensor(rng.normal(size=(8, 3, 13, 4)),
                            dtype=torch.float32) for n in "qkv"}
    args["bias"] = torch.zeros(3, 13, 13)
    args["region"] = torch.zeros(4, 13)
    change(args)
    with pytest.raises(err):
        fused_window_attention(args["q"], args["k"], args["v"], args["bias"],
                               args["region"])
