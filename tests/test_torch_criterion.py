"""Port parity of the box utilities, the on-device targets, the matcher and
the criterion (``transoar_tpu_torch.utils.boxes``, ``models.matcher``,
``models.criterion``) against the JAX package, with the same numpy inputs
made from a seed.

Tolerances: the box arithmetic and the losses are the same f32 operations
in the same order up to fusion, 1e-6 absolute on boxes and IoUs and 1e-5
relative on losses; the targets, the numpy copies and the matches are
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import synthetic_batch, tiny_config
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.models import criterion as jcrit
from transoar_tpu.models.anchors import generate_anchors
from transoar_tpu.models.matcher import match as jmatch
from transoar_tpu.utils import boxes as jboxes
from transoar_tpu_torch.models import criterion as tcrit
from transoar_tpu_torch.models.matcher import match
from transoar_tpu_torch.utils import boxes as tboxes

ORGANS, QPO, B = 3, 7, 2


def _boxes(rng, *shape):
    c = rng.uniform(0.2, 0.8, size=(*shape, 3))
    s = rng.uniform(0.05, 0.4, size=(*shape, 3))
    return np.concatenate([c, s], -1).astype(np.float32)


def test_box_functions_match_jax(rng):
    a, b = _boxes(rng, 2, 5), _boxes(rng, 2, 4)
    for name in ("box_cxcyczwhd_to_xyzxyz", "box_xyzxyz_to_cxcyczwhd"):
        ref = np.asarray(getattr(jboxes, name)(jnp.asarray(a)))
        np.testing.assert_allclose(
            getattr(tboxes, name)(torch.from_numpy(a)).numpy(), ref,
            atol=1e-6)
        np.testing.assert_allclose(getattr(tboxes, name)(a), ref, atol=1e-6)
    ca, cb = jboxes.box_cxcyczwhd_to_xyzxyz(a), jboxes.box_cxcyczwhd_to_xyzxyz(b)
    ta, tb = torch.from_numpy(ca), torch.from_numpy(cb)
    np.testing.assert_allclose(tboxes.box_volume(ta).numpy(),
                               jboxes.box_volume(ca), atol=1e-7)
    for name in ("box_iou_pairwise", "generalized_box_iou_pairwise"):
        ref = getattr(jboxes, name)(jnp.asarray(ca), jnp.asarray(cb))
        ours = getattr(tboxes, name)(ta, tb)
        for o, r in zip(ours if isinstance(ours, tuple) else [ours],
                        ref if isinstance(ref, tuple) else [ref]):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)
    cb5 = jboxes.box_cxcyczwhd_to_xyzxyz(_boxes(rng, 2, 5))
    for name in ("box_iou_elementwise", "generalized_box_iou_elementwise"):
        ref = getattr(jboxes, name)(jnp.asarray(ca), jnp.asarray(cb5))
        ours = getattr(tboxes, name)(ta, torch.from_numpy(cb5))
        for o, r in zip(ours if isinstance(ours, tuple) else [ours],
                        ref if isinstance(ref, tuple) else [ref]):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


def _labels(cfg, rng):
    _, seg = synthetic_batch(cfg, batch_size=B, seed=int(rng.integers(100)))
    seg[1][seg[1] == 2] = 0           # organ 2 absent in the second volume
    seg[0, 3:20, 4:6, 2:12] = 3       # a slab thinner than min_extent
    return seg


def test_segmentation2bbox_matches_jax(rng):
    cfg = tiny_config(num_organs=ORGANS, qpo=QPO)
    seg = _labels(cfg, rng)
    for padding, normalize in ((1, True), (0, False)):
        ref_b, ref_p = jboxes.segmentation2bbox(
            jnp.asarray(seg), ORGANS, padding=padding, normalize=normalize)
        ours_b, ours_p = tboxes.segmentation2bbox(
            torch.from_numpy(seg), ORGANS, padding=padding,
            normalize=normalize)
        np.testing.assert_array_equal(ours_p.numpy(), np.asarray(ref_p))
        np.testing.assert_allclose(ours_b.numpy(), np.asarray(ref_b),
                                   atol=1e-7)
    assert not ours_p[1, 1] and ours_p.sum() >= 3


def test_numpy_copies_exact(rng):
    cfg = tiny_config(num_organs=ORGANS, qpo=QPO)
    seg = _labels(cfg, rng)
    for fmt in ("cxcyczwhd", "xyzxyz"):
        for ours, ref in zip(tboxes.segmentation2bbox_np(seg[0],
                                                         box_format=fmt),
                             jboxes.segmentation2bbox_np(seg[0],
                                                         box_format=fmt)):
            np.testing.assert_array_equal(ours, ref)
    a, b = _boxes(rng, 5), _boxes(rng, 3)
    np.testing.assert_array_equal(tboxes.box_iou_np(a, b),
                                  jboxes.box_iou_np(a, b))


def _setup(rng, anchor_matching=True):
    cfg = tiny_config(num_organs=ORGANS, qpo=QPO)
    cfg["matching"].update(anchor_matching=anchor_matching,
                           cost_bbox=0 if anchor_matching else 2,
                           cost_giou=0 if anchor_matching else 1)
    anchors, _ = generate_anchors(cfg["neck"], cfg["bbox_properties"])
    Q = ORGANS * QPO
    out = {"pred_logits": rng.normal(size=(B, Q, 1)),
           "pred_boxes": np.clip(anchors[None] + rng.normal(
               scale=0.02, size=(B, Q, 6)), 0, 1),
           "aux_logits": rng.normal(size=(2, B, Q, 1)),
           "aux_boxes": np.clip(anchors[None, None] + rng.normal(
               scale=0.03, size=(2, B, Q, 6)), 0, 1)}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    tgt_boxes, present = jboxes.segmentation2bbox(
        jnp.asarray(_labels(cfg, rng)), ORGANS)
    return cfg, anchors, out, np.array(tgt_boxes), np.array(present)


@pytest.mark.parametrize("anchor_matching", [True, False])
def test_match_matches_jax(rng, anchor_matching):
    cfg, anchors, out, tb, tp = _setup(rng, anchor_matching)
    m = cfg["matching"]
    kw = dict(cost_class=m["cost_class"], cost_bbox=m["cost_bbox"],
              cost_giou=m["cost_giou"], anchor_matching=anchor_matching)
    ref_m, ref_s = jmatch(jnp.asarray(out["pred_logits"]),
                          jnp.asarray(out["pred_boxes"]), jnp.asarray(anchors),
                          jnp.asarray(tb), jnp.asarray(tp), ORGANS, **kw)
    ours_m, ours_s = match(torch.from_numpy(out["pred_logits"]),
                           torch.from_numpy(out["pred_boxes"]),
                           torch.from_numpy(anchors), torch.from_numpy(tb),
                           torch.from_numpy(tp), ORGANS, **kw)
    np.testing.assert_array_equal(ours_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(ours_s.numpy(), np.asarray(ref_s), atol=1e-6)
    assert (ours_s.numpy() == -1).any()  # an absent organ


@pytest.mark.parametrize("aux_on_final,present_total", [
    (False, None), (True, None), (False, 7)])
def test_criterion_matches_jax(rng, aux_on_final, present_total):
    cfg, anchors, out, tb, tp = _setup(rng)
    cfg["neck"]["aux_loss_on_final"] = aux_on_final
    ref = jcrit.Criterion(cfg)(
        {k: jnp.asarray(v) for k, v in out.items()},
        {"boxes": jnp.asarray(tb), "present": jnp.asarray(tp)},
        jnp.asarray(anchors), present_total=present_total)
    crit = tcrit.build_criterion(cfg)
    ours = crit({k: torch.from_numpy(v) for k, v in out.items()},
                {"boxes": torch.from_numpy(tb),
                 "present": torch.from_numpy(tp)},
                torch.from_numpy(anchors), present_total=present_total)
    assert set(ours) == set(ref)
    for key in ref:
        np.testing.assert_allclose(float(ours[key]), float(ref[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(
        float(tcrit.total_loss(ours, cfg["loss_coefs"])),
        float(jcrit.total_loss(ref, cfg["loss_coefs"])), rtol=1e-5)


def test_criterion_gradient_flows_to_the_outputs(rng):
    cfg, anchors, out, tb, tp = _setup(rng)
    outs = {k: torch.from_numpy(v).requires_grad_() for k, v in out.items()}
    losses = tcrit.Criterion(cfg)(outs, {"boxes": torch.from_numpy(tb),
                                         "present": torch.from_numpy(tp)},
                                  torch.from_numpy(anchors))
    tcrit.total_loss(losses, cfg["loss_coefs"]).backward()
    for key, v in outs.items():
        assert torch.isfinite(v.grad).all() and v.grad.abs().sum() > 0, key


@pytest.mark.parametrize("change,kind,seg", [
    (lambda c: c["neck"].update(name="detr"), "SetCriterion", False),
    (lambda c: c["neck"].update(name="def_detr"), "SetCriterion", False),
    (lambda c: c["backbone"].update(use_seg_proxy_loss=True), "Criterion",
     True),
    (lambda c: c.update(retina={}), "RetinaCriterion", False),
    (lambda c: (c.update(retina={}),
                c["backbone"].update(use_seg_proxy_loss=True)),
     "RetinaCriterion", True),
])
def test_criterion_dispatch(change, kind, seg):
    """The DETR necks take the set criterion, the seg proxy the focused one
    with its seg losses, a ``retina`` section RetinaNet's focal criterion
    (Retina U-Net with the seg losses); each raised before its port."""
    cfg = tiny_config()
    change(cfg)
    crit = tcrit.build_criterion(cfg)
    assert type(crit).__name__ == kind
    assert getattr(crit, "seg_proxy", False) == seg
