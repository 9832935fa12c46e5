"""The port's deformable refine (``use_decoder_attn``) against the
benchmark's plain reference (``benchmark/reference/refine.py``) on the
CPU, in f32, from one dict of seeded weights
(``benchmark.reference.weights``): the sampling op, the refine block, the
whole model's outputs, and the gradients of the refine's leaves.

Tiny refine (``presets.tiny_config("refine")``: P2-P3 at 8x8x4 + 4x4x2
tokens, 6 heads of 16, 2 points, 2 layers), batch 2.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from benchmark.reference import refine as ref
from benchmark.reference.weights import make_weights
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu_torch import presets
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.ops.deformable_attention import ms_deform_attn

SHAPES = [(4, 3, 2), (2, 2, 1)]


def _op_inputs(seed, edges):
    """value [2, S, 2, 4], locations [2, Q, 2, 2, P, 3], weights: random
    locations in [-0.3, 1.3] (outside the level on all sides), plus with
    ``edges`` points exactly on a level's edges (0, 1) and on voxel
    boundaries and centres (k / (2n), every axis's n)."""
    gen = torch.Generator().manual_seed(seed)
    S = sum(int(np.prod(s)) for s in SHAPES)
    value = torch.randn(2, S, 2, 4, generator=gen)
    loc = torch.rand(2, 24, 2, 2, 3, 3, generator=gen) * 1.6 - 0.3
    if edges:
        grid = sorted({k / (2 * n) for n in (1, 2, 3, 4) for k in
                       range(2 * n + 1)})
        exact = torch.tensor(list(itertools.product(grid, repeat=3)))
        exact = exact[torch.randperm(len(exact), generator=gen)[:24 * 12]]
        loc = exact.reshape(24, 2, 2, 3, 3)[None].repeat(2, 1, 1, 1, 1, 1)
        loc[1] = loc[1].flip(0)
    weights = torch.rand(2, 24, 2, 2, 3, generator=gen)
    return value, loc, weights


@pytest.mark.parametrize("edges", [False, True])
def test_sampling_matches_the_explicit_corners(edges):
    """Forward equal to f32 rounding (8 corners x 6 points summed in
    another order: 1e-5 on values of order 1); the gradients of the value,
    the locations and the weights likewise at random points, where every
    corner set is fixed (on a voxel boundary the location's gradient is
    one-sided, and each side may take either)."""
    value, loc, weights = _op_inputs(5, edges)
    got = ms_deform_attn(value, SHAPES, loc, weights)
    want = ref.sample(value, SHAPES, loc, weights, block=7)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert want.abs().max() > 0.1 and (got == 0).sum() < got.numel()
    if edges:
        return
    leaves = [t.clone().requires_grad_() for t in (value, loc, weights)]
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
    grads_port = torch.autograd.grad((ms_deform_attn(
        leaves[0], SHAPES, *leaves[1:]) * g).sum(), leaves)
    grads_ref = torch.autograd.grad((ref.sample(
        leaves[0], SHAPES, *leaves[1:], block=7) * g).sum(), leaves)
    for a, b in zip(grads_port, grads_ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    """(config, port model in f32 and train mode, reference weights,
    constants, batch) from one dict of seeded weights."""
    cfg = presets.tiny_config("refine")
    cfg["trainer"]["batch_size"] = 2
    weights = make_weights(ref.param_shapes(cfg), 2 ** 31 + 7, "cpu")
    torch.manual_seed(0)
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    assert set(model.state_dict()) == set(weights)
    model.load_state_dict(weights)
    x = torch.randn(2, *cfg["augmentation"]["patch_size"], 1,
                    generator=torch.Generator().manual_seed(3))
    return cfg, model, weights, ref.constants(cfg, "cpu"), x


def test_refine_block_and_model_outputs_match(pair):
    """The refine block's output on the same FPN levels (post-norm values
    of order 1: 1e-4), then the whole model: logits 2e-4 and boxes 2e-5,
    ``tests/test_model_parity.py``'s f32 tolerances (boxes are tanh x a
    0.1 restriction, so ten times tighter)."""
    cfg, model, weights, consts, x = pair
    model.eval()
    names = cfg["backbone"]["def_attn"]["feature_levels"]
    decoder = model._backbone._decoder
    with torch.no_grad():
        # the P-levels the refine takes: the decoder without its refine
        decoder.refine_levels = []
        try:
            fmaps = [model._backbone(x)[n] for n in names]
        finally:
            decoder.refine_levels = list(names)
        got = decoder._refine(fmaps)
        want = ref.refine(fmaps, weights, cfg, consts)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
        out = model(x)
        want = ref.forward(weights, x, cfg, consts)
    torch.testing.assert_close(out["pred_logits"], want["pred_logits"],
                               atol=2e-4, rtol=0)
    torch.testing.assert_close(out["pred_boxes"], want["pred_boxes"],
                               atol=2e-5, rtol=0)
    torch.testing.assert_close(out["aux_logits"], want["aux_logits"],
                               atol=2e-4, rtol=0)


def test_refine_gradients_match_in_train_mode(pair):
    """One train-mode forward and backward on both sides, dropout drawn
    from one seed in the port's order: every refine leaf's gradient within
    1e-2 relative L2 (``tests/test_model_parity.py``: f32 round-off through
    the encoder, the refine and the neck's softmaxes, far below any
    mechanism's error)."""
    cfg, model, weights, consts, x = pair
    model.train()
    model.zero_grad()
    out = model(x, torch.Generator().manual_seed(11))
    P = {n: w.clone().requires_grad_() for n, w in weights.items()}
    want = ref.forward(P, x, cfg, consts, torch.Generator().manual_seed(11),
                       train=True)
    proj = torch.Generator().manual_seed(12)
    a = torch.randn(out["pred_logits"].shape, generator=proj)
    b = torch.randn(out["pred_boxes"].shape, generator=proj)

    def loss(o):
        return (o["pred_logits"] * a).sum() + (o["pred_boxes"] * b).sum() \
            + o["aux_logits"].square().mean()

    loss(out).backward()
    loss(want).backward()
    params = dict(model.named_parameters())
    leaves = [n for n in P if n.startswith(ref.PREFIX)]
    assert len(leaves) == 1 + 2 * 16
    for n in leaves:
        g, r = params[n].grad, P[n].grad
        rel = float((g - r).norm() / r.norm().clamp_min(1e-12))
        assert r.norm() > 0 and rel < 1e-2, f"{n}: rel grad err {rel:.2e}"
