"""RetinaNet and Retina U-Net against the JAX package at f32, on the tiny
``presets.tiny_config("retina" | "retina_unet")`` (P2-P3, K = 4 anchors a
voxel, 3 organs, 32x32x16), weights bridged by ``state_dict_from_jax``:

- ``encode_deltas`` / ``decode_deltas`` (1e-6) and the focal loss;
- the forward: ``anchor_logits`` / ``anchor_deltas`` (and ``pred_seg``)
  within 2e-4, and the flattening order (anchor ``voxel * K + k``, class
  channel ``k * C + c``) pinned on its own;
- ``RetinaCriterion``: every loss within 1e-4 relative, with positives,
  ignored and negative anchors present;
- one train step: loss 1e-4, every gradient below 1e-2 rel-L2;
- ``nms_3d`` / ``batched_class_nms``: the same kept indices as the JAX
  functions on seeded boxes without ties, with leading dimensions;
- ``retina_inference``: classes equal, boxes and scores within 1e-4.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import synthetic_batch
from tests.torch_parity import (apply, assert_grads_close, init_params, load,
                                t, train_step_pair)
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.models import retina as jretina
from transoar_tpu.ops import nms as jnms
from transoar_tpu.training.trainer import derive_targets as jderive
from transoar_tpu_torch.models import retina
from transoar_tpu_torch.models.criterion import build_criterion
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.ops import nms
from transoar_tpu_torch.presets import tiny_config
from transoar_tpu_torch.training.trainer import derive_targets
from transoar_tpu_torch.utils.weights import state_dict_from_jax

ORGANS = 3


def _cfg(family):
    cfg = tiny_config(family, num_organs=ORGANS)
    cfg["trainer"]["precision"] = "float32"
    return cfg


@pytest.fixture(scope="module", params=["retina", "retina_unet"])
def pair(request):
    cfg = _cfg(request.param)
    image, seg = synthetic_batch(cfg, batch_size=2, seed=3)
    jmodel = jretina.build_retinanet(cfg)
    params = init_params(jmodel, jnp.asarray(image), seed=4)
    port = load(build_model(cfg), state_dict_from_jax(params, cfg))
    ref = {k: np.asarray(v) for k, v in
           apply(jmodel, params, jnp.asarray(image)).items()}
    with torch.inference_mode():
        ours = {k: v.numpy() for k, v in port(t(image)).items()}
    return SimpleNamespace(cfg=cfg, image=image, seg=seg, jmodel=jmodel,
                           params=params, port=port, ref=ref, ours=ours)


def test_deltas_match_jax(rng):
    def boxes(n):
        return np.concatenate([rng.uniform(0.2, 0.8, (n, 3)),
                               rng.uniform(0.0, 0.3, (n, 3))],
                              -1).astype(np.float32)

    anchors, gt = boxes(64), boxes(64)
    gt[:4, 3:] = 0.0  # absent slots: the size clipped at 1e-6
    ref = np.asarray(jretina.encode_deltas(jnp.asarray(gt),
                                           jnp.asarray(anchors)))
    ours = retina.encode_deltas(t(gt), t(anchors)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    deltas = rng.normal(0, 4, (64, 6)).astype(np.float32)  # clipped at +-6
    ref = np.asarray(jretina.decode_deltas(jnp.asarray(deltas),
                                           jnp.asarray(anchors)))
    ours = retina.decode_deltas(t(deltas), t(anchors)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def test_focal_loss_matches_jax(rng):
    logits = rng.normal(0, 4, (50, 3)).astype(np.float32)
    targets = (rng.uniform(size=(50, 3)) < 0.3).astype(np.float32)
    ref = jretina.sigmoid_focal_loss(jnp.asarray(logits),
                                     jnp.asarray(targets), 0.3, 1.5)
    ours = retina.sigmoid_focal_loss(t(logits), t(targets), 0.3, 1.5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


def test_forward_matches_jax(pair):
    ref, ours = pair.ref, pair.ours
    seg_proxy = pair.cfg["backbone"]["use_seg_proxy_loss"]
    keys = {"anchor_logits", "anchor_deltas"} | (
        {"pred_seg"} if seg_proxy else set())
    assert set(ours) == set(ref) == keys
    A = len(pair.jmodel.anchors)
    assert A == 4 * (8 * 8 * 4 + 4 * 4 * 2)
    assert ours["anchor_logits"].shape == (2, A, ORGANS)
    assert ours["anchor_deltas"].shape == (2, A, 6)
    for key in keys:
        assert ours[key].dtype == np.float32
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=2e-4,
                                   err_msg=key)
    torch.testing.assert_close(pair.port.anchors,
                               torch.from_numpy(pair.jmodel.anchors))


def test_flattening_order():
    """Zero weights and a distinct bias per out channel: anchor voxel * K + k
    of each level reads the class channels k * C + c and the delta
    channels k * 6 + j."""
    cfg = _cfg("retina")
    model = build_model(cfg).eval()
    K = 4
    for tower, width in ((model._cls_tower, ORGANS), (model._reg_tower, 6)):
        with torch.no_grad():
            tower.out.weight.zero_()
            tower.out.bias.copy_(torch.arange(K * width, dtype=torch.float32))
    with torch.inference_mode():
        out = model(torch.zeros(1, 32, 32, 16, 1))
    _, counts = retina.build_anchors(cfg)
    for key, width in (("anchor_logits", ORGANS), ("anchor_deltas", 6)):
        want = torch.arange(K * width, dtype=torch.float32).view(K, width)
        start = 0
        for n in counts:
            level = out[key][0, start:start + n].view(n // K, K, width)
            assert torch.equal(level, want.expand_as(level)), key
            start += n


def _targets(cfg, seg):
    j = jderive(jnp.asarray(seg), ORGANS)
    ours = derive_targets(torch.from_numpy(seg).long(), ORGANS)
    np.testing.assert_allclose(ours["boxes"].numpy(), np.asarray(j["boxes"]),
                               atol=1e-6)
    return j, ours


def test_criterion_matches_jax(pair):
    cfg = pair.cfg
    jt, tt = _targets(cfg, pair.seg)
    ref = jretina.RetinaCriterion(cfg)(
        {k: jnp.asarray(v) for k, v in pair.ref.items()}, jt,
        jnp.asarray(pair.jmodel.anchors))
    crit = build_criterion(cfg)
    assert type(crit).__name__ == "RetinaCriterion"
    anchors = t(pair.jmodel.anchors)
    ours = crit({k: t(v) for k, v in pair.ref.items()}, tt, anchors)
    assert set(ours) == set(ref)
    for key in ref:
        assert ours[key].dtype == torch.float32
        np.testing.assert_allclose(float(ours[key]), float(ref[key]),
                                   rtol=1e-4, atol=1e-7, err_msg=key)
    _, best_iou = crit.assign(tt["boxes"].float(), tt["present"], anchors)
    pos = best_iou >= crit.pos_iou
    ignored = ~pos & (best_iou >= crit.neg_iou)
    assert pos.sum() > 0 and ignored.sum() > 0 and (~pos & ~ignored).sum()
    if cfg["backbone"]["use_seg_proxy_loss"]:
        assert float(ours["segce"]) > 0 and float(ours["segdice"]) > 0


def test_train_step_matches_jax(pair):
    cfg = pair.cfg
    port = load(build_model(cfg), state_dict_from_jax(pair.params, cfg))
    loss, losses, grads, ours = train_step_pair(
        cfg, pair.jmodel, pair.params, port, pair.image, pair.seg)
    np.testing.assert_allclose(float(ours["total"]), loss, rtol=1e-4)
    for key, val in losses.items():
        np.testing.assert_allclose(float(ours[key]), val, rtol=1e-4,
                                   atol=1e-7, err_msg=key)
    assert_grads_close(port, grads)
    # both towers are shared over the levels: one weight each, its
    # gradient summed over P2 and P3
    names = [n for n, _ in port.named_parameters() if "tower" in n]
    assert sorted(names) == sorted(
        f"_{tw}.{c}.{w}" for tw in ("cls_tower", "reg_tower")
        for c in ("conv0", "out") for w in ("weight", "bias"))


def _nms_case(seed, lead, N):
    """Corner boxes in clusters (so that suppression happens) and distinct
    scores."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, (*lead, 6, 3))[..., rng.integers(
        0, 6, N), :] + rng.normal(0, 0.03, (*lead, N, 3))
    sizes = rng.uniform(0.05, 0.2, (*lead, N, 3))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1)
    scores = rng.permutation(N * int(np.prod(lead))).reshape(*lead, N)
    return boxes.astype(np.float32), (scores / scores.size).astype(np.float32)


@pytest.mark.parametrize("iou,max_out,thresh", [(0.5, 10, None),
                                                 (0.3, 60, 0.4),
                                                 (0.1, 5, 0.05)])
def test_nms_matches_jax(iou, max_out, thresh):
    boxes, scores = _nms_case(max_out, (2, 3), 40)
    keep, valid = nms.nms_3d(t(boxes), t(scores), iou, max_out, thresh)
    assert keep.shape == valid.shape == (2, 3, max_out)
    suppressed = 0
    for i in np.ndindex(2, 3):
        rk, rv = jnms.nms_3d(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                             iou, max_out, thresh)
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(rv))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(rk))
        kept = np.asarray(rk)[np.asarray(rv)]
        by_score = np.argsort(-scores[i])[:len(kept)]
        suppressed += not np.array_equal(kept, by_score)
    assert suppressed > 0  # not merely the best scores in order


def test_batched_class_nms_matches_jax():
    boxes, scores = _nms_case(5, (), 50)
    classes = np.random.default_rng(6).integers(0, 3, 50)
    rk, rv = jnms.batched_class_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(classes), 0.3, 30)
    keep, valid = nms.batched_class_nms(t(boxes), t(scores),
                                        torch.from_numpy(classes), 0.3, 30)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rk))


@pytest.mark.parametrize("kwargs", [{}, {"iou_threshold": 0.3, "max_out": 5,
                                         "score_threshold": 0.4}])
def test_retina_inference_matches_jax(pair, kwargs):
    ref = jretina.retina_inference(pair.ref, pair.jmodel.anchors, ORGANS,
                                   **kwargs)
    ours = retina.retina_inference({k: t(v) for k, v in pair.ref.items()},
                                   pair.port.anchors, ORGANS, **kwargs)
    # no ties among each class's scores, so both keep the same candidates
    probs = 1 / (1 + np.exp(-pair.ref["anchor_logits"]))
    for b in range(2):
        for c in range(ORGANS):
            assert len(np.unique(probs[b, :, c])) == probs.shape[1]
    kept = 0
    for (rb, rc, rs), (ob, oc, os) in zip(zip(*ref), zip(*ours)):
        np.testing.assert_array_equal(oc, rc)
        assert oc.dtype == np.int64
        np.testing.assert_allclose(os, rs, rtol=0, atol=1e-4)
        np.testing.assert_allclose(ob, rb, rtol=0, atol=1e-4)
        kept += len(oc)
    assert kept > 0
