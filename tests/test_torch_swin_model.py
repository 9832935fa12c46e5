"""The Swin slice as a whole: a tiny SwinFPN TransoarNet of the port against
the JAX package's, then the train and predict CLIs on it.

tiny_config at f32 with Swin stages 2-3 (5x5x5 windows, 2 heads, depths
[2, 2], drop_path_rate 0.2) at 40x40x16 and ``stage0_pack: 4``: stage 2
pads its 20x20x8 input to 32 windows and shifts them in its second block;
stage 3's 10x10x4 input clamps the window to 5x5x4. Both sides get the same
parameters, the flax init with the zero heads overwritten by seeded values,
bridged by ``state_dict_from_jax``. JAX side: its default (blocked) Swin
attention, deterministic; port side: the fused window attention's plain
version, in ``eval()`` (no dropout, no DropPath), both at batch 2.
Tolerances, as tests/test_model_parity.py: logits 2e-4, boxes 2e-5; one
train step (no clipping: ``clip_max_norm: -1``): loss rtol 1e-4,
per-tensor gradient rel-L2 < 1e-2 above a floor of 1e-5 of the global
norm.
"""

import copy
import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.helpers import synthetic_batch, tiny_config
from tests.torch_parity import randomize
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.models.criterion import Criterion as JCriterion
from transoar_tpu.models.criterion import total_loss as jtotal_loss
from transoar_tpu.models.transoarnet import build_transoarnet as build_jax
from transoar_tpu.training.trainer import derive_targets as jderive
from transoar_tpu.utils.torch_import import map_reference_state_dict
from transoar_tpu_torch import predict, train
from transoar_tpu_torch.data.synthetic import generate_dataset
from transoar_tpu_torch.models.criterion import build_criterion
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.ops.kernels import window_attention as wa
from transoar_tpu_torch.presets import tiny_swin_config, write_ct_volumes
from transoar_tpu_torch.training import train_state as tstate
from transoar_tpu_torch.training.trainer import make_train_step
from transoar_tpu_torch.utils.weights import state_dict_from_jax


def _config():
    cfg = tiny_config(precision="float32", patch=(40, 40, 16))
    cfg["backbone"].update(start_channels=8, use_encoder_attn=True,
                           stage0_pack=4)
    cfg["backbone"]["swin"] = {
        "depths": [2, 2], "num_heads": [2, 2], "window_size": [5, 5, 5],
        "mlp_ratio": 4, "qkv_bias": True, "drop_path_rate": 0.2,
        "conv_merging": False}
    return cfg


@pytest.fixture(scope="module")
def slice_run():
    cfg = _config()
    image, seg = synthetic_batch(cfg, batch_size=2, seed=1)
    jmodel = build_jax(cfg)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.key(0), jnp.asarray(image))["params"])
    params["cls_head"] = randomize(params["cls_head"], 1)
    params["reg_head"]["Dense_2"] = randomize(params["reg_head"]["Dense_2"],
                                              2)
    crit = JCriterion(cfg)
    anchors = jnp.asarray(jmodel.anchors)
    targets = jderive(jnp.asarray(seg), cfg["neck"]["num_organs"])

    def loss_fn(p):  # one compile gives the forward and the train step
        out = jmodel.apply({"params": p}, jnp.asarray(image),
                           deterministic=True)
        return jtotal_loss(crit(out, targets, anchors),
                           cfg["loss_coefs"]), out

    (loss, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    grads = jax.tree.map(np.asarray, grads)

    port = build_model(cfg).eval()  # no dropout or DropPath
    port.load_state_dict(state_dict_from_jax(params, cfg))
    loaded = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    counts = (wa.fused_window_attention.launches,
              wa.fused_window_attention_bwd.launches)
    with torch.inference_mode():
        ours = {k: v.numpy()
                for k, v in port(torch.from_numpy(image)).items()}
    optimizer, scheduler = tstate.make_optimizer(port, cfg, 1)
    step = make_train_step(port, build_criterion(cfg), optimizer, scheduler,
                           cfg)
    losses = step({"image": torch.from_numpy(image),
                   "seg": torch.from_numpy(seg)})
    return SimpleNamespace(
        cfg=cfg, params=params, port=port, loaded=loaded, ref=ref, ours=ours,
        loss=float(loss), ours_loss=float(losses["total"]),
        ref_grads=state_dict_from_jax(grads, cfg),
        norm=float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                               for g in jax.tree.leaves(grads)))),
        launched=(wa.fused_window_attention.launches - counts[0],
                  wa.fused_window_attention_bwd.launches - counts[1]))


def test_forward_matches_jax(slice_run):
    ref, ours = slice_run.ref, slice_run.ours
    assert set(ours) == set(ref)
    for key, tol in (("pred_logits", 2e-4), ("aux_logits", 2e-4),
                     ("pred_boxes", 2e-5), ("aux_boxes", 2e-5)):
        assert ours[key].shape == ref[key].shape, key
        np.testing.assert_allclose(ours[key], ref[key], atol=tol, err_msg=key)
    assert np.ptp(ours["pred_logits"]) > 1e-2


def test_train_step_matches_jax(slice_run):
    run = slice_run
    np.testing.assert_allclose(run.ours_loss, run.loss, rtol=1e-4)
    floor = 1e-5 * run.norm
    swin = [n for n in run.ref_grads if ".blocks." in n]
    assert any("relative_position_bias_table" in n for n in swin)
    for name, p in run.port.named_parameters():
        ref = run.ref_grads[name]
        if ref.norm() < floor:
            assert p.grad.norm() < 10 * floor, name
            continue
        rel = float((p.grad - ref).norm() / max(float(ref.norm()), floor))
        assert rel < 1e-2, f"{name}: rel grad err {rel:.2e}"


def test_cpu_runs_no_kernel(slice_run):
    assert slice_run.launched == (0, 0)


def test_bridge_round_trip_through_reference_mapping(slice_run):
    """port state_dict -> map_reference_state_dict (the reference torch
    names, Swin stages included) gives back every JAX leaf exactly."""
    sd = slice_run.loaded  # before the train step moved it
    zeros = jax.tree.map(np.zeros_like, slice_run.params)
    back = map_reference_state_dict(sd, zeros, slice_run.cfg)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(slice_run.params))
    assert len(flat_back) == len(flat_ref)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), flat_ref[path],
                                      err_msg=jax.tree_util.keystr(path))


def test_train_then_predict_cli(tmp_path, monkeypatch):
    """chip_smoke.py's Swin phases rehearsed on the CPU at tiny size: one
    epoch in train() mode (DropPath drawn from the trainer's generator),
    then predict from the run directory."""
    cfg = tiny_swin_config()
    for key in ("bbox_properties", "labels", "labels_small", "labels_mid",
                "labels_large"):
        cfg.pop(key)  # the dataset's data_info.json provides them
    cfg.update(dataset="syn", experiment_name="swin", debug_mode=False)
    cfg["augmentation"]["use_augmentation"] = False
    cfg["trainer"].update(epochs=1, batch_size=2, microbatch="grads")
    generate_dataset(tmp_path / "dataset", name="syn",
                     shape=tuple(cfg["augmentation"]["patch_size"]),
                     num_classes=cfg["neck"]["num_organs"], num_train=2,
                     num_val=2, num_test=0, seed=1)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "swin.yaml").write_text(yaml.safe_dump(cfg))
    handlers = logging.root.handlers[:]
    try:
        trainer = train.main(["--config", str(tmp_path / "swin.yaml"),
                              "--device", "cpu"])
        assert np.isfinite(trainer.history[-1]["train"]["total"])
        assert (tmp_path / "runs" / "swin" / "model_last.pt").exists()
        inputs = write_ct_volumes(tmp_path, [(44, 40, 18)], seed=2)
        records = predict.main(["--run", "swin", "--input", *inputs,
                                "--device", "cpu"])
    finally:
        logging.root.handlers[:] = handlers
    dets = records[0]["detections"]
    assert sorted(d["class"] for d in dets) == \
        list(range(1, cfg["neck"]["num_organs"] + 1))
    assert all(np.isfinite(d["box_cxcyczwhd_norm"]).all() for d in dets)


def test_swin_config_builds_at_full_width():
    from transoar_tpu_torch.presets import swin_fpn_config

    cfg = swin_fpn_config()
    model = build_model(copy.deepcopy(cfg), device="meta")
    stages = model._backbone._encoder._stages
    assert [len(stages[s].blocks) for s in range(2, 6)] == [2, 2, 2, 2]
    assert [stages[s].blocks[0].attn.num_heads for s in range(2, 6)] == \
        [3, 6, 12, 24]
    rates = [b.drop_path for s in range(2, 6) for b in stages[s].blocks]
    np.testing.assert_allclose(rates, np.linspace(0, 0.2, 8))
    assert model._backbone._encoder.swin_from == 2
