"""The DETR family against the JAX package at f32, and the exact matcher.

- ``models/hungarian``: the exact assignment equals a brute-force optimum
  over every injection of G <= 5 rows into Q <= 7 columns, ties and a cost
  range of 1e-6 to 1e3 included, and the JAX auction's assignment where
  the optimum is unique; where the auction's fixed eps loses (small costs
  beside one large entry) the auction's assignment costs more and the
  exact one is the brute-force optimum: the exact side is right.
- Both necks (``DETRDecoder``, ``DeformableDETRDecoder``) alone (1e-5), the
  whole tiny DETR and Deformable-DETR models (logits 2e-4, boxes 2e-5),
  DETR's exported attention weights, ``SetCriterion`` (losses 1e-4, with
  absent slots) and one train step of each (loss 1e-4, gradients below
  1e-2 rel-L2; the JAX side's auction and the exact matcher agree on these
  costs), weights bridged by ``state_dict_from_jax``.
"""

import itertools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import synthetic_batch, tiny_config
from tests.torch_parity import (apply, assert_grads_close, forward_pair,
                                init_params, load, model_pair, t,
                                train_step_pair)
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.models import detr as jdetr
from transoar_tpu.models.hungarian import auction_assignment
from transoar_tpu.training.inference import inference as jax_inference
from transoar_tpu_torch.models import detr, hungarian
from transoar_tpu_torch.models.criterion import build_criterion
from transoar_tpu_torch.training.inference import inference
from transoar_tpu_torch.utils import weights


def _brute(cost):
    """Least total cost over every injection of rows into columns."""
    G, Q = cost.shape
    return min(cost[np.arange(G), list(p)].sum()
               for p in itertools.permutations(range(Q), G))


def _total(cost, cols):
    return cost[np.arange(len(cols)), cols].sum()


def _cases(seed, n):
    rng = np.random.default_rng(seed)
    for i in range(n):
        G = int(rng.integers(1, 6))
        Q = int(rng.integers(G, 8))
        kind = i % 3
        if kind == 0:  # ties: few distinct integer costs
            cost = rng.integers(0, 3, size=(G, Q)).astype(np.float64)
        elif kind == 1:  # dynamic range 1e-6 .. 1e3
            cost = 10.0 ** rng.uniform(-6, 3, size=(G, Q))
        else:
            cost = rng.normal(size=(G, Q))
        yield cost


def test_exact_matcher_is_the_brute_force_optimum():
    for cost in _cases(0, 60):
        cols = hungarian.assign(cost, np.ones(cost.shape[0], bool))
        assert len(set(cols.tolist())) == len(cols)  # one to one
        np.testing.assert_allclose(_total(cost, cols), _brute(cost),
                                   rtol=1e-12, atol=1e-12)


def test_exact_matcher_on_present_rows_only():
    rng = np.random.default_rng(1)
    cost = rng.normal(size=(2, 3, 5, 7))  # [L, B, G, Q]
    present = rng.uniform(size=(3, 5)) < 0.6
    present[0] = False  # a case with no organ
    got = hungarian.hungarian_match(torch.from_numpy(cost).float(),
                                    torch.from_numpy(present))
    assert got.dtype == torch.int64 and got.shape == (2, 3, 5)
    for lyr, b in itertools.product(range(2), range(3)):
        rows = np.flatnonzero(present[b])
        cols = got[lyr, b].numpy()
        assert (cols[~present[b]] == -1).all()
        if rows.size:
            sub = cost[lyr, b][rows].astype(np.float32)
            np.testing.assert_allclose(_total(sub, cols[rows]), _brute(sub),
                                       rtol=1e-6)


def test_exact_matcher_equals_the_auction_on_unique_optima():
    rng = np.random.default_rng(2)
    for _ in range(20):
        G, Q = int(rng.integers(2, 6)), int(rng.integers(6, 12))
        cost = (rng.normal(size=(G, Q)) * 3).astype(np.float32)
        ours = hungarian.assign(cost, np.ones(G, bool))
        auction = np.asarray(auction_assignment(jnp.asarray(cost)))
        np.testing.assert_array_equal(ours, auction)


def test_auction_loses_where_its_eps_is_coarse():
    """Costs below 1e-2 beside one entry of 1e3: the auction's eps (1e-2 x
    the largest cost / (G + 1)) is larger than the gaps between
    assignments, so it stops at a worse one; the exact assignment is the
    brute-force optimum."""
    rng = np.random.default_rng(0)
    worse = 0
    for _ in range(30):
        G = int(rng.integers(2, 6))
        Q = int(rng.integers(G, 8))
        cost = rng.uniform(0, 1e-2, size=(G, Q)).astype(np.float32)
        cost[rng.integers(G), rng.integers(Q)] = 1e3
        ours = _total(cost, hungarian.assign(cost, np.ones(G, bool)))
        np.testing.assert_allclose(ours, _brute(cost), rtol=1e-6)
        auction = _total(cost, np.asarray(auction_assignment(
            jnp.asarray(cost))))
        assert auction >= ours - 1e-6
        worse += auction > ours + 1e-6
    assert worse >= 5


def test_non_finite_costs_still_assign():
    cost = np.full((2, 3), np.nan)
    cols = hungarian.assign(cost, np.ones(2, bool))
    assert (cols >= 0).all() and len(set(cols.tolist())) == 2


def _detr_cfg(name):
    """tests/test_detr.py's tiny DETR configs."""
    cfg = tiny_config(num_organs=3, qpo=7, precision="float32")
    cfg["neck"].update(name=name, num_queries=12, anchor_offset_pred=False)
    cfg["matching"].update(cost_class=2, cost_bbox=5, cost_giou=2,
                           eos_coef=0.1)
    if name == "def_detr":
        cfg["neck"].update(feature_levels=["P2", "P3"], n_points=2, nheads=6)
        cfg["backbone"]["out_fmaps"] = ["P2", "P3"]
    return cfg


def _neck_state(params, layers):
    sd = {}
    for i in range(layers):
        sd.update({f"layers.{i}.{k}": v for k, v in
                   weights.detr_layer(params[f"layer{i}"]).items()})
    if "ref_points" in params:
        sd.update({f"ref_points.{k}": v for k, v in
                   weights.dense(params["ref_points"]).items()})
    return weights.to_torch(sd)


def test_detr_decoder_matches_jax():
    cfg = _detr_cfg("detr")["neck"]
    rng = np.random.default_rng(3)
    src = rng.normal(size=(2, 4, 3, 2, 24)).astype(np.float32)
    pos = rng.normal(size=src.shape).astype(np.float32)
    query = rng.normal(size=(12, 48)).astype(np.float32)
    jmod = jdetr.DETRDecoder(cfg, dtype=jnp.float32)
    params = init_params(jmod, src, query, pos, seed=4)
    want, _ = apply(jmod, params, src, query, pos)
    port = load(detr.DETRDecoder(cfg, torch.float32),
                _neck_state(params, cfg["dec_layers"]))
    with torch.inference_mode():
        got = port(t(src), t(query), t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_deformable_detr_decoder_matches_jax():
    cfg = _detr_cfg("def_detr")["neck"]
    rng = np.random.default_rng(5)
    fmaps = [rng.normal(size=(2, *s, 24)).astype(np.float32)
             for s in ((4, 4, 2), (2, 2, 1))]
    query = rng.normal(size=(12, 48)).astype(np.float32)
    jmod = jdetr.DeformableDETRDecoder(cfg, dtype=jnp.float32)
    params = init_params(jmod, fmaps, query, seed=6)
    want, want_ref = apply(jmod, params, fmaps, query)
    port = load(detr.DeformableDETRDecoder(cfg, 2, torch.float32),
                _neck_state(params, cfg["dec_layers"]))
    with torch.inference_mode():
        got, ref = port([t(f) for f in fmaps], t(query))
    np.testing.assert_allclose(ref.numpy(), np.asarray(want_ref), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.fixture(scope="module", params=["detr", "def_detr"])
def model_run(request):
    cfg = _detr_cfg(request.param)
    image, seg = synthetic_batch(cfg, batch_size=2, seed=7)
    jmodel, params, port = model_pair(cfg, image, seed=8)
    ref, ours = forward_pair(jmodel, params, port, image)
    return SimpleNamespace(name=request.param, cfg=cfg, image=image, seg=seg,
                           jmodel=jmodel, params=params, port=port, ref=ref,
                           ours=ours)


def test_model_matches_jax(model_run):
    ref, ours = model_run.ref, model_run.ours
    assert set(ours) == set(ref) == {"pred_logits", "pred_boxes",
                                     "aux_logits", "aux_boxes"}
    assert ours["pred_logits"].shape == (2, 12, 4)  # organs + no-object
    for key in ref:
        tol = 2e-4 if "logits" in key else 2e-5
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=tol,
                                   err_msg=key)
    assert np.ptp(ours["pred_logits"]) > 1e-2
    # the softmax-over-classes decode, copied from the JAX package
    organs = model_run.cfg["neck"]["num_organs"]
    for a, b in zip(inference(ours, organs), jax_inference(ours, organs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_detr_attention_weights_match_jax(model_run):
    x = model_run.image[:1]
    want = jax.jit(lambda p, x: model_run.jmodel.apply(
        {"params": p}, x, return_weights=True))(model_run.params,
                                                jnp.asarray(x))
    with torch.inference_mode():
        got = model_run.port(t(x), return_weights=True)
    if model_run.name == "def_detr":  # sparse sampling: no dense map
        assert want["attn_weights"] is None
        assert "attn_weights" not in got and "backbone_fmap" not in got
        return
    S = int(np.prod(got["backbone_fmap"].shape[1:4]))
    assert got["attn_weights"].shape == (1, 12, S)
    # tests/test_torch_evaluation.py's tolerance for the exported maps
    for key in ("attn_weights", "backbone_fmap"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=2e-4, err_msg=key)
    sums = got["attn_weights"].sum(-1)
    torch.testing.assert_close(sums, torch.ones_like(sums))


def _targets(cfg, seed, absent=()):
    rng = np.random.default_rng(seed)
    G = cfg["neck"]["num_organs"]
    c = rng.uniform(0.3, 0.7, size=(2, G, 3))
    s = rng.uniform(0.1, 0.3, size=(2, G, 3))
    present = np.ones((2, G), bool)
    for b, g in absent:
        present[b, g] = False
    return (np.concatenate([c, s], -1).astype(np.float32), present)


@pytest.mark.parametrize("absent", [(), ((0, 1), (1, 0), (1, 2))])
def test_set_criterion_matches_jax(model_run, absent):
    cfg = model_run.cfg
    boxes, present = _targets(cfg, 9, absent)
    jcrit = jdetr.SetCriterion(cfg)
    want = jcrit({k: jnp.asarray(v) for k, v in model_run.ref.items()},
                 {"boxes": jnp.asarray(boxes),
                  "present": jnp.asarray(present)})
    crit = build_criterion(cfg)
    assert isinstance(crit, detr.SetCriterion)
    got = crit({k: t(v) for k, v in model_run.ref.items()},
               {"boxes": t(boxes), "present": torch.from_numpy(present)})
    assert list(got) == list(want)
    for key, ref in want.items():
        np.testing.assert_allclose(float(got[key]), float(ref), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    # one copy to the host for all layers
    assert len(crit.clock.wait_ms) == len(crit.clock.solve_ms) == 1


def test_absent_slots_do_not_write_to_query_0():
    """Query 0 matched to a present organ keeps that organ's class target
    when absent slots follow; absent slots add no box loss."""
    cfg = _detr_cfg("detr")
    crit = detr.SetCriterion(cfg)
    boxes, present = _targets(cfg, 10, ((0, 1), (0, 2)))
    logits = torch.zeros(1, 12, 4)
    logits[0, 0, 1] = 10.0  # query 0 is class 1's obvious match
    pred = torch.rand(1, 12, 6, generator=torch.Generator().manual_seed(0))
    pred[0, 0] = t(boxes[0, 0])
    assign = torch.tensor([[0, -1, -1]])
    ce, l1, giou = crit._losses(logits, pred, assign, t(boxes[:1]),
                                torch.from_numpy(present[:1]))
    logp = logits.log_softmax(-1)[0]
    weights = torch.full((12,), 0.1)
    weights[0] = 1.0
    target = torch.zeros(12, dtype=torch.long)
    target[0] = 1
    want = -(logp[torch.arange(12), target] * weights).sum() / weights.sum()
    torch.testing.assert_close(ce, want)
    # the one present box is predicted exactly (GIoU's eps leaves ~1e-5)
    assert float(l1) == 0.0 and float(giou) < 1e-4


def test_train_step_matches_jax(model_run):
    loss, losses, grads, ours = train_step_pair(
        model_run.cfg, model_run.jmodel, model_run.params, model_run.port,
        model_run.image, model_run.seg)
    np.testing.assert_allclose(float(ours["total"]), loss, rtol=1e-4)
    for key, ref in losses.items():
        np.testing.assert_allclose(float(ours[key]), ref, rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    assert_grads_close(model_run.port, grads)


def test_remat_replays_the_dropout_masks():
    """In training with dropout, the DETR decoder under remat gives the
    same outputs and gradients as without it from the same generator
    state, and leaves the generator where the plain run leaves it: the
    recompute draws the forward's masks."""
    cfg = dict(_detr_cfg("detr")["neck"], dropout=0.3)
    rng = np.random.default_rng(11)
    src = t(rng.normal(size=(2, 4, 3, 2, 24)))
    pos = t(rng.normal(size=src.shape))
    query = t(rng.normal(size=(12, 48)))
    runs = []
    for remat in (True, False):
        torch.manual_seed(0)
        dec = detr.DETRDecoder(dict(cfg, remat=remat), torch.float32)
        for m in dec.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(torch.Generator().manual_seed(1))
        dec.train()
        gen = torch.Generator().manual_seed(2)
        x = src.clone().requires_grad_()
        out = dec(x, query, pos, gen)
        out.square().sum().backward()
        runs.append((out.detach(), x.grad, gen.get_state(),
                     {n: p.grad for n, p in dec.named_parameters()}))
    (o1, g1, s1, p1), (o2, g2, s2, p2) = runs
    with torch.no_grad():  # dropout was on
        assert (o2 - dec.eval()(src, query, pos)).abs().max() > 1e-2
    torch.testing.assert_close(o1, o2)
    torch.testing.assert_close(g1, g2)
    assert torch.equal(s1, s2)
    for name in p2:
        torch.testing.assert_close(p1[name], p2[name], msg=name)
