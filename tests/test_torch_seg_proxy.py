"""The seg-proxy family (``use_seg_proxy_loss``) against the JAX package at
f32: ``soft_dice_loss`` and ``loss_segmentation`` (1e-4), the whole tiny
model with the full-resolution decoder path and the seg head (logits 2e-4,
boxes 2e-5, ``pred_seg`` 2e-4) and one train step (loss 1e-4, gradients
below 1e-2 rel-L2), weights bridged by ``state_dict_from_jax``."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import synthetic_batch, tiny_config
from tests.torch_parity import (assert_grads_close, forward_pair, model_pair,
                                t, train_step_pair)
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.models import criterion as jcrit
from transoar_tpu_torch.models import criterion as tcrit


def _seg_case(seed, K=3, shape=(2, 6, 5, 4)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(*shape, K)).astype(np.float32)
    labels = rng.integers(0, 4, size=shape).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("fg_bg", [True, False])
def test_loss_segmentation_matches_jax(fg_bg):
    logits, labels = _seg_case(1, K=2 if fg_bg else 4)
    ref = jcrit.loss_segmentation(jnp.asarray(logits), jnp.asarray(labels),
                                  fg_bg=fg_bg)
    ours = tcrit.loss_segmentation(t(logits), torch.from_numpy(labels),
                                   fg_bg=fg_bg)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4)


def test_soft_dice_loss_matches_jax():
    logits, labels = _seg_case(2, K=4)
    onehot = np.eye(4, dtype=np.float32)[labels]
    ref = jcrit.soft_dice_loss(jnp.asarray(logits), jnp.asarray(onehot))
    ours = tcrit.soft_dice_loss(t(logits), t(onehot))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-4)
    perfect = np.where(onehot > 0, 30.0, -30.0).astype(np.float32)
    assert float(tcrit.soft_dice_loss(t(perfect), t(onehot))) < 1e-5


@pytest.fixture(scope="module")
def seg_run():
    cfg = tiny_config(seg_proxy=True, precision="float32")
    image, seg = synthetic_batch(cfg, batch_size=2, seed=3)
    jmodel, params, port = model_pair(cfg, image, seed=4)
    ref, ours = forward_pair(jmodel, params, port, image)
    return SimpleNamespace(cfg=cfg, image=image, seg=seg, jmodel=jmodel,
                           params=params, port=port, ref=ref, ours=ours)


def test_seg_model_matches_jax(seg_run):
    ref, ours = seg_run.ref, seg_run.ours
    assert set(ours) == set(ref) == {"pred_logits", "pred_boxes",
                                     "aux_logits", "aux_boxes", "pred_seg"}
    patch = seg_run.cfg["augmentation"]["patch_size"]
    assert ours["pred_seg"].shape == (2, *patch, 2)
    assert ours["pred_seg"].dtype == np.float32
    for key, tol in (("pred_logits", 2e-4), ("aux_logits", 2e-4),
                     ("pred_seg", 2e-4), ("pred_boxes", 2e-5),
                     ("aux_boxes", 2e-5)):
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=tol,
                                   err_msg=key)
    assert np.ptp(ours["pred_seg"]) > 1e-2


def test_seg_decoder_runs_to_full_resolution(seg_run):
    dec = seg_run.port._backbone._decoder
    assert dec.stages_needed == [0, 2] and dec.earliest == 0
    start = seg_run.cfg["backbone"]["start_channels"]
    assert dec._out[0].weight.shape[0] == start
    assert tuple(seg_run.port._seg_head.weight.shape) == (2, start, 1, 1, 1)


def test_seg_train_step_matches_jax(seg_run):
    loss, losses, grads, ours = train_step_pair(
        seg_run.cfg, seg_run.jmodel, seg_run.params, seg_run.port,
        seg_run.image, seg_run.seg)
    assert losses["segce"] > 0 and losses["segdice"] > 0
    np.testing.assert_allclose(float(ours["total"]), loss, rtol=1e-4)
    for key, ref in losses.items():
        np.testing.assert_allclose(float(ours[key]), ref, rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    assert_grads_close(seg_run.port, grads)
    assert seg_run.port._seg_head.weight.grad.abs().sum() > 0
