"""The port's evaluation path against the JAX package on the CPU: the
attention weights ``return_weights=True`` exports (RoI and dense
cross-attention) within the logits tolerance 2e-4, ``python -m
transoar_tpu_torch.test --val`` against ``scripts/test.py`` on the same
weights and split (``results_val.json`` within 1e-4), for the flagship and
for RetinaNet (its NMS decode with the config's thresholds), the
``import_checkpoint`` round trip (the forward bit-equal after import), and
the refusals that match the JAX CLIs (RetinaNet in ``predict`` and
``import_checkpoint``)."""

import argparse
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.helpers import tiny_config
from tests.torch_parity import init_params
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.eval import evaluator as jax_evaluator
from transoar_tpu.models.transoarnet import build_transoarnet as build_jax
from transoar_tpu.training import checkpoints as jckpt
from transoar_tpu.training.train_state import TrainState, make_optimizer
from transoar_tpu_torch import import_checkpoint, test as test_cli
from transoar_tpu_torch.data.synthetic import generate_dataset
from transoar_tpu_torch.eval import evaluator as port_evaluator
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.training import checkpoints as ckpt_lib
from transoar_tpu_torch.utils.io import load_json
from transoar_tpu_torch.utils.weights import (random_state_dict,
                                              state_dict_from_jax)

INFO_KEYS = ("labels", "labels_small", "labels_mid", "labels_large",
             "bbox_properties", "foreground_voxel_statistics")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny flagship config over a synthetic split, the JAX model with
    seeded random parameters and the port model with the same ones."""
    root = tmp_path_factory.mktemp("eval")
    ds = generate_dataset(root / "dataset", name="syn", shape=(32, 32, 16),
                          num_classes=3, num_train=2, num_val=3, num_test=0,
                          seed=4)
    cfg = tiny_config(num_organs=3, qpo=7)
    cfg["dataset"] = "syn"
    info = load_json(ds / "data_info.json")
    cfg.update({k: info[k] for k in INFO_KEYS})
    x = np.random.default_rng(1).normal(
        0.5, 0.5, size=(1, 32, 32, 16, 1)).astype(np.float32)
    jmodel = build_jax(cfg)
    params = init_params(jmodel, jnp.asarray(x), seed=3)
    port = build_model(cfg).eval()
    port.load_state_dict(state_dict_from_jax(params, cfg))
    return SimpleNamespace(root=root, cfg=cfg, x=x, jmodel=jmodel,
                           params=params, port=port)


def _jax_state(jmodel, cfg, params):
    """``create_train_state``'s state holding ``params``, without its
    eager flax init (the params it draws would be replaced at once)."""
    return TrainState.create(apply_fn=jmodel.apply,
                             params=jax.tree.map(jnp.asarray, params),
                             tx=make_optimizer(cfg, 1))


def _template_train_state(model, config, example, rng):
    """``create_train_state`` without its flax init: zeros of the init's
    shapes and dtypes, traced, not run op by op. scripts/test.py takes only
    these from the state, the template its checkpoint restores into."""
    shapes = jax.eval_shape(model.init, rng, example)["params"]
    return _jax_state(model, config, jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), shapes))


@pytest.mark.parametrize("roi", [True, False])
def test_attention_weights_match_jax(tiny, roi):
    cfg = dict(tiny.cfg, neck=dict(tiny.cfg["neck"], roi_attention=roi))
    jmodel = build_jax(cfg)
    port = build_model(cfg).eval()
    port.load_state_dict(tiny.port.state_dict())
    assert port._neck.use_roi == roi
    ref = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, return_weights=True))(tiny.params,
                                                jnp.asarray(tiny.x))
    with torch.inference_mode():
        ours = port(torch.from_numpy(tiny.x), return_weights=True)
    Q, H = cfg["neck"]["num_queries"], cfg["neck"]["nheads"]
    assert ours["attn_weights"].shape == (1, H, Q, 8 * 8 * 4)
    assert ours["self_attn_weights"].shape == (1, Q, Q)
    for key in ("attn_weights", "self_attn_weights", "backbone_fmap",
                "pred_logits"):
        np.testing.assert_allclose(ours[key].float().numpy(),
                                   np.asarray(ref[key], np.float32),
                                   rtol=0, atol=2e-4, err_msg=key)
    # each query's weights cover only its organ's attention area
    sums = ours["attn_weights"].sum(-1)
    torch.testing.assert_close(sums, torch.ones_like(sums))


def test_test_cli_matches_scripts_test(tiny, monkeypatch):
    from scripts import test as jax_test_cli

    monkeypatch.chdir(tiny.root)
    monkeypatch.setattr(jax_test_cli, "create_train_state",
                        _template_train_state)
    state = _jax_state(tiny.jmodel, tiny.cfg, tiny.params)
    jrun, run = tiny.root / "runs" / "jexp", tiny.root / "runs" / "texp"
    jckpt.freeze_run_config(tiny.cfg, jrun)
    jckpt.save_checkpoint(jrun, "model_last", state, 1, 0.0)
    ckpt_lib.freeze_run_config(tiny.cfg, run)
    ckpt_lib.save_checkpoint(run, "model_last", tiny.port)

    # what each CLI hands its evaluator, case by case
    fed = {"ref": [], "ours": []}
    for side, cls in (("ref", jax_evaluator.DetectionEvaluator),
                      ("ours", port_evaluator.DetectionEvaluator)):
        def add(self, *args, _add=cls.add, _into=fed[side], **kwargs):
            _into.append((args, kwargs))
            return _add(self, *args, **kwargs)
        monkeypatch.setattr(cls, "add", add)

    data_dir = str(tiny.root / "dataset")
    ref = jax_test_cli.Tester(argparse.Namespace(
        run="jexp", val=True, last=True, full_labeled=False,
        save_preds=False, save_attn_map=False, data_dir=data_dir)).run()
    ours = test_cli.main(["--run", "texp", "--val", "--last", "--device",
                          "cpu", "--data_dir", data_dir])
    assert load_json(run / "results_val.json") == ours
    # the seeded weights hit some boxes and miss others, so the scores
    # tell decoders apart: neither all 0 nor all 1
    assert 0 < ref["mAP_coco"] < 1 and 0 < ref["AP_IoU_0.75"] < 1
    assert ours.keys() == ref.keys()
    for key in ours:
        np.testing.assert_allclose(ours[key], ref[key], atol=1e-4,
                                   err_msg=key)
    assert len(fed["ours"]) == len(fed["ref"]) == 3
    for (args, kw), (ref_args, ref_kw) in zip(fed["ours"], fed["ref"]):
        boxes, classes, scores = (a[0] for a in args[:3])
        ref_boxes, ref_classes, ref_scores = (a[0] for a in ref_args[:3])
        np.testing.assert_array_equal(classes, ref_classes)
        np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-4)
        np.testing.assert_allclose(boxes, ref_boxes, rtol=0, atol=1e-4)
        for key in ("gt_boxes", "gt_classes"):
            np.testing.assert_array_equal(kw[key][0], ref_kw[key][0])


def test_test_cli_retina_matches_scripts_test(tiny, monkeypatch):
    """A tiny RetinaNet run (K = 4 anchors a voxel, P2-P3) through both
    CLIs: the port decodes with the config's ``nms_iou`` and
    ``score_threshold`` (0.3 and 0.2 here, not the decode's defaults), as
    ``scripts/test.py`` calls JAX's ``retina_inference``; the same
    detections case by case (classes equal, scores 1e-4, boxes 1e-4 +
    1e-3 relative: the forward's 2e-4 on the deltas, scaled by exp(delta))
    and ``results_val.json`` within 1e-4."""
    from scripts import test as jax_test_cli
    from transoar_tpu.models.retina import build_retinanet
    from transoar_tpu_torch.presets import tiny_config as port_tiny

    monkeypatch.chdir(tiny.root)
    monkeypatch.setattr(jax_test_cli, "create_train_state",
                        _template_train_state)
    cfg = port_tiny("retina", num_organs=3)
    cfg["trainer"]["precision"] = "float32"
    cfg["retina"].update(nms_iou=0.3, score_threshold=0.2)
    cfg.update({k: tiny.cfg[k] for k in ("dataset", *INFO_KEYS)})
    jmodel = build_retinanet(cfg)
    params = init_params(jmodel, jnp.asarray(tiny.x), seed=6)
    state = _jax_state(jmodel, cfg, params)
    jrun, run = tiny.root / "runs" / "jret", tiny.root / "runs" / "tret"
    jckpt.freeze_run_config(cfg, jrun)
    jckpt.save_checkpoint(jrun, "model_last", state, 1, 0.0)
    port = build_model(cfg)
    port.load_state_dict(state_dict_from_jax(params, cfg))
    ckpt_lib.freeze_run_config(cfg, run)
    ckpt_lib.save_checkpoint(run, "model_last", port)

    fed = {"ref": [], "ours": []}
    for side, cls in (("ref", jax_evaluator.DetectionEvaluator),
                      ("ours", port_evaluator.DetectionEvaluator)):
        def add(self, *args, _add=cls.add, _into=fed[side], **kwargs):
            _into.append((args, kwargs))
            return _add(self, *args, **kwargs)
        monkeypatch.setattr(cls, "add", add)

    data_dir = str(tiny.root / "dataset")
    ref = jax_test_cli.Tester(argparse.Namespace(
        run="jret", val=True, last=True, full_labeled=False,
        save_preds=False, save_attn_map=True, data_dir=data_dir)).run()
    tester = test_cli.Tester(argparse.Namespace(
        run="tret", val=True, last=True, full_labeled=False,
        save_preds=False, save_attn_map=True, data_dir=data_dir,
        device="cpu"))
    ours = tester.run()
    assert load_json(run / "results_val.json") == ours
    assert ours.keys() == ref.keys()
    for key in ours:
        np.testing.assert_allclose(ours[key], ref[key], atol=1e-4,
                                   err_msg=key)
    assert len(fed["ours"]) == len(fed["ref"]) == len(tester.case_ms) == 3
    assert all(v >= 0 for ms in tester.case_ms for v in ms.values())
    kept = 0
    for (args, _), (ref_args, _) in zip(fed["ours"], fed["ref"]):
        boxes, classes, scores = (a[0] for a in args[:3])
        ref_boxes, ref_classes, ref_scores = (a[0] for a in ref_args[:3])
        np.testing.assert_array_equal(classes, ref_classes)
        np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-4)
        # the forward's deltas agree within 2e-4; a box's size is its
        # anchor's times exp(delta), so its error scales with the box
        np.testing.assert_allclose(boxes, ref_boxes, rtol=1e-3, atol=1e-4)
        assert scores.min() >= 0.2
        kept += len(classes)
    assert kept > 0


def test_predict_refuses_retina(tiny):
    """scripts/predict.py has no RetinaNet decode, and the port's predict
    says so instead of failing inside the decode."""
    from transoar_tpu_torch import predict
    from transoar_tpu_torch.presets import tiny_config as port_tiny

    run = tiny.root / "runs" / "pret"
    ckpt_lib.freeze_run_config(port_tiny("retina"), run)
    with pytest.raises(ValueError, match="scripts/predict.py"):
        predict.load_predictor(run, device="cpu")


def test_import_checkpoint_round_trip(tiny, monkeypatch):
    """A reference trainer's checkpoint file -> runs/<name>/ -> the same
    forward, bit for bit, through the test CLI's restore."""
    monkeypatch.chdir(tiny.root)
    model = build_model(tiny.cfg).eval()
    model.load_state_dict(random_state_dict(model, 9))
    torch.save({"epoch": 12, "metric_max_val": 0.25,
                "model_state_dict": model.state_dict(),
                "optimizer_state_dict": {"state": {}}},
               tiny.root / "reference.pt")
    cfg_path = tiny.root / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(tiny.cfg,
                                            experiment_name="tinyexp")))
    target = import_checkpoint.main(["--checkpoint",
                                     str(tiny.root / "reference.pt"),
                                     "--config", str(cfg_path)])
    run = tiny.root / "runs" / "imported_tinyexp"
    assert target == run / "model_best_0.250.pt"
    assert load_json(run / "config.json")["experiment_name"] == \
        "imported_tinyexp"
    tester = test_cli.Tester(argparse.Namespace(
        run="imported_tinyexp", val=True, last=False, full_labeled=False,
        save_preds=False, save_attn_map=False, data_dir=None,
        device="cpu"))
    with torch.inference_mode():
        want = model(torch.from_numpy(tiny.x))
        got = tester._model(torch.from_numpy(tiny.x))
    for key in want:
        assert torch.equal(got[key], want[key]), key
    fresh = build_model(tiny.cfg)
    from transoar_tpu_torch.training.train_state import make_optimizer

    optimizer, scheduler = make_optimizer(fresh, tiny.cfg)
    epoch, best = ckpt_lib.restore_checkpoint(target, fresh, optimizer,
                                              scheduler)
    assert (epoch, best) == (12, 0.25) and not optimizer.state

    bad = dict(model.state_dict())
    bad.pop("_query_embed.weight")
    torch.save(bad, tiny.root / "bare.pt")
    with pytest.raises(RuntimeError, match="_query_embed.weight"):
        import_checkpoint.main(["--checkpoint", str(tiny.root / "bare.pt"),
                                "--config", str(cfg_path), "--name", "x"])


@pytest.mark.parametrize("family", ["refine", "seg", "detr", "def_detr",
                                    "retina"])
def test_import_checkpoint_families(tiny, monkeypatch, family):
    """The refine and the seg proxy import through the reference layout (a
    strict load, then the same forward); the DETR necks and RetinaNet, whose
    reference branches this checkout lacks, refuse with a clear error, as
    scripts/import_torch_checkpoint.py does for RetinaNet."""
    from transoar_tpu_torch.presets import tiny_config as port_tiny

    monkeypatch.chdir(tiny.root)
    cfg = dict(port_tiny(family), experiment_name=f"imp_{family}")
    model = build_model(cfg).eval()
    model.load_state_dict(random_state_dict(model, 5))
    torch.save(model.state_dict(), tiny.root / f"{family}.pt")
    cfg_path = tiny.root / f"{family}.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    args = ["--checkpoint", str(tiny.root / f"{family}.pt"),
            "--config", str(cfg_path)]
    if family in ("detr", "def_detr", "retina"):
        want = "RetinaNet" if family == "retina" else f"{family} neck"
        with pytest.raises(ValueError, match=want):
            import_checkpoint.main(args)
        return
    target = import_checkpoint.main(args)
    restored = build_model(cfg).eval()
    restored.load_state_dict(ckpt_lib.load_checkpoint(target, "cpu"))
    x = torch.from_numpy(tiny.x)
    with torch.inference_mode():
        want, got = model(x), restored(x)
    for key in want:
        assert torch.equal(got[key], want[key]), key
