"""The port's serving slice as a whole against the JAX package.

tiny_config at f32 with ``stage0_pack: 4``: the JAX side runs the packed
stage-0 chain through its Pallas kernel (``TRANSOAR_PALLAS_CONV=1``,
``stage0_pack_batch1``, interpret mode on the CPU), the port through its
packed_conv wrapper (the plain version on the CPU). Both get the same
parameters: the flax init with the zero-initialised heads overwritten by
seeded values (else every query scores alike), bridged by
``state_dict_from_jax``. Tolerances are tests/test_model_parity.py's:
logits 2e-4, boxes 2e-5.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.helpers import tiny_config
from tests.torch_parity import randomize
from transoar_tpu.models.transoarnet import build_transoarnet as build_jax
from transoar_tpu.ops.pallas import packed_conv as jpacked
from transoar_tpu.training.inference import inference as jax_inference
from transoar_tpu.utils.torch_import import map_reference_state_dict
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.ops import conv3d as tconv
from transoar_tpu_torch.training.inference import inference
from transoar_tpu_torch.utils.weights import state_dict_from_jax


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapped(*args):
        calls.append(1)
        return fn(*args)

    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.fixture(scope="module")
def slice_run():
    cfg = tiny_config(precision="float32")
    cfg["backbone"]["stage0_pack"] = 4
    cfg["backbone"]["stage0_pack_batch1"] = True
    x = np.random.default_rng(0).normal(
        size=(1, *cfg["augmentation"]["patch_size"], 1)).astype(np.float32)

    jmodel = build_jax(cfg)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.key(0), jnp.asarray(x))["params"])
    params["cls_head"] = randomize(params["cls_head"], 1)
    params["reg_head"]["Dense_2"] = randomize(params["reg_head"]["Dense_2"],
                                              2)
    port = build_model(cfg).eval()  # no dropout, as deterministic apply
    port.load_state_dict(state_dict_from_jax(params, cfg))

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRANSOAR_PALLAS_CONV", "1")
        jcalls = _counting(mp, jpacked, "packed_conv")
        tcalls = _counting(mp, tconv, "packed_conv")
        with pltpu.force_tpu_interpret_mode():
            ref = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
                params, jnp.asarray(x))
        with torch.inference_mode():
            ours = port(torch.from_numpy(x))
    return SimpleNamespace(
        cfg=cfg, params=params, jmodel=jmodel, port=port,
        ref={k: np.asarray(v) for k, v in ref.items()},
        ours={k: v.numpy() for k, v in ours.items()},
        jcalls=len(jcalls), tcalls=len(tcalls))


def test_both_sides_take_the_packed_kernel_path(slice_run):
    # both stage-0 convs, on each side
    assert slice_run.jcalls == 2 and slice_run.tcalls == 2


def test_forward_matches_jax(slice_run):
    ref, ours = slice_run.ref, slice_run.ours
    assert set(ours) == set(ref) == {"pred_logits", "pred_boxes",
                                     "aux_logits", "aux_boxes"}
    for key, tol in (("pred_logits", 2e-4), ("aux_logits", 2e-4),
                     ("pred_boxes", 2e-5), ("aux_boxes", 2e-5)):
        assert ours[key].shape == ref[key].shape, key
        np.testing.assert_allclose(ours[key], ref[key], atol=tol, err_msg=key)
    # the seeded heads make the scores differ across queries
    assert np.ptp(ours["pred_logits"]) > 1e-2


def test_decode_matches_jax(slice_run):
    cfg, ref, ours = slice_run.cfg, slice_run.ref, slice_run.ours
    organs = cfg["neck"]["num_organs"]
    qpo = cfg["neck"]["num_queries"] // organs
    # same best query per organ on both sides
    np.testing.assert_array_equal(
        ours["pred_logits"].reshape(organs, qpo).argmax(-1),
        ref["pred_logits"].reshape(organs, qpo).argmax(-1))
    # the copied numpy decode is the JAX one, bit for bit
    for a, b in zip(inference(ours, organs), jax_inference(ours, organs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    (boxes, classes, scores), (rb, rc, rs) = (inference(ours, organs),
                                              inference(ref, organs))
    np.testing.assert_array_equal(classes[0], rc[0])
    np.testing.assert_allclose(boxes[0], rb[0], atol=2e-5)
    np.testing.assert_allclose(scores[0], rs[0], atol=5e-5)


def test_bridge_writes_every_parameter(slice_run):
    sd = state_dict_from_jax(slice_run.params, slice_run.cfg)
    expected = slice_run.port.state_dict()
    assert set(sd) == set(expected)
    for name, value in sd.items():
        assert value.shape == expected[name].shape, name


def test_bridge_round_trip_through_reference_mapping(slice_run):
    """port state_dict -> map_reference_state_dict onto an all-zero flax
    tree gives back every JAX leaf exactly."""
    sd = {k: v.numpy() for k, v in slice_run.port.state_dict().items()}
    zeros = jax.tree.map(np.zeros_like, slice_run.params)
    back = map_reference_state_dict(sd, zeros, slice_run.cfg)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(slice_run.params))
    assert len(flat_back) == len(flat_ref)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_ref[path],
                                      err_msg=jax.tree_util.keystr(path))


def test_serving_cli_matches_jax_predict(slice_run, tmp_path, monkeypatch):
    """NIfTI in -> predictions json out through the port's CLI on the CPU,
    against scripts/predict.py's pipeline driving the JAX model with the
    same weights: same grid, same window, same detections."""
    from scripts import predict as jax_predict
    from transoar_tpu.data.nifti import write_nifti
    from transoar_tpu.data.transforms import eval_transform
    from transoar_tpu.utils.io import load_json
    from transoar_tpu_torch import predict
    from transoar_tpu_torch.training import checkpoints as ckpt_lib

    cfg = dict(slice_run.cfg)
    stats = {"percentile_00_5": -0.5, "percentile_99_5": 1.5}
    cfg["foreground_voxel_statistics"] = stats
    run_dir = tmp_path / "runs" / "pexp"
    ckpt_lib.freeze_run_config(cfg, run_dir)
    ckpt_lib.save_checkpoint(run_dir, "model_best_0.5", slice_run.port)

    # a raw case with a non-RAS orientation and a shape off the grid
    vol = np.random.default_rng(3).normal(0.45, 0.6, size=(40, 37, 21))
    affine = np.diag([-1.5, -1.5, 2.0, 1.0])
    affine[:3, 3] = (60.0, 55.5, -42.0)
    case = tmp_path / "case7.nii.gz"
    write_nifti(vol.astype(np.float32), case, affine=affine)

    monkeypatch.chdir(tmp_path)
    records = predict.main(["--run", "pexp", "--input", str(case),
                            "--device", "cpu", "--save_boxmask"])
    out_dir = run_dir / "predictions"
    dets = load_json(out_dir / "case7_predictions.json")["detections"]
    assert (out_dir / "case7_boxmask.nii.gz").exists()
    assert len(records) == 1 and records[0]["detections"] == dets
    assert len(dets) == cfg["neck"]["num_organs"]

    patch = cfg["augmentation"]["patch_size"]
    for ours, ref in zip(predict.prepare_volume(case, patch),
                         jax_predict.prepare_volume(case, patch)):
        np.testing.assert_array_equal(ours, ref)

    monkeypatch.setenv("TRANSOAR_PALLAS_CONV", "1")
    jmodel = slice_run.jmodel
    forward = jax.jit(lambda p, img: jmodel.apply(
        {"params": p}, eval_transform(img, stats)))
    with pltpu.force_tpu_interpret_mode():
        ref_dets = jax_predict.predict_case(case, cfg, slice_run.params,
                                            forward)[0]
    assert len(ref_dets) == len(dets)
    for ours, ref in zip(dets, ref_dets):
        assert ours["class"] == ref["class"] and ours["name"] == ref["name"]
        assert abs(ours["score"] - ref["score"]) < 5e-5
        np.testing.assert_allclose(ours["box_cxcyczwhd_norm"],
                                   ref["box_cxcyczwhd_norm"], atol=2e-5)
        for key in ("voxel_lo", "voxel_hi", "world_mm_lo", "world_mm_hi"):
            np.testing.assert_allclose(ours[key], ref[key], atol=2e-3,
                                       err_msg=key)
