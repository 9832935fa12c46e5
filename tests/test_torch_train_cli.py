"""The port's train CLI on the CPU, on a tiny synthetic dataset: train ->
checkpoints -> ``--auto_resume`` -> ``predict`` from the run directory;
with the shipped augmentation setting (host, through the native loader)
train -> ``test --val`` -> ``predict`` for the flagship, the SwinFPN, the
seg proxy, DETR and Deformable DETR, train -> ``test --val`` for RetinaNet
and Retina U-Net (gradient accumulation on the latter); one step with ``on_device: true`` (``chip_smoke.py``'s training, test and
on-device phases, rehearsed at tiny size)."""

import argparse
import copy
import logging

import numpy as np
import pytest
import torch
import yaml

from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu_torch import predict, test, train
from transoar_tpu_torch.data.synthetic import generate_dataset
from transoar_tpu_torch.data.transforms import HostAugmentingLoader
from transoar_tpu_torch.native.native_loader import NativeLoader
from transoar_tpu_torch.presets import (tiny_config, tiny_flagship_config,
                                        tiny_swin_config, write_ct_volumes)
from transoar_tpu_torch.training import checkpoints as ckpt_lib
from transoar_tpu_torch.training import trainer as trainer_lib
from transoar_tpu_torch.utils.io import get_config, load_json, validate_config


def _setup(tmp_path, monkeypatch, cfg, name, num_train=4):
    """``cfg`` on disk over a ``num_train`` + 2 case synthetic dataset whose
    data_info.json gives the statistics; cwd is the run root. Returns the
    config and the dataset root."""
    for key in ("bbox_properties", "labels", "labels_small", "labels_mid",
                "labels_large", "foreground_voxel_statistics"):
        cfg.pop(key, None)  # the dataset's data_info.json provides them
    cfg.update(dataset="syn", experiment_name=name, debug_mode=False)
    cfg["trainer"].update(epochs=1, batch_size=2)
    generate_dataset(tmp_path / "dataset", name="syn",
                     shape=tuple(cfg["augmentation"]["patch_size"]),
                     num_classes=cfg["neck"]["num_organs"],
                     num_train=num_train, num_val=2, num_test=0, seed=1)
    monkeypatch.chdir(tmp_path)
    return cfg, str(tmp_path / "dataset")


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    """One epoch of a tiny flagship config without augmentation, trained
    once for the tests that start from it: (run root, config, trainer).
    Restores the cwd and the root logger the CLIs reconfigure."""
    root = tmp_path_factory.mktemp("first")
    cfg = tiny_flagship_config()
    cfg["augmentation"]["use_augmentation"] = False
    handlers = logging.root.handlers[:]
    with pytest.MonkeyPatch.context() as mp:
        cfg, _ = _setup(root, mp, cfg, "tiny")
        trainer = train.main(["--config", _write(root / "tiny.yaml", cfg),
                              "--device", "cpu"])
    logging.root.handlers[:] = handlers
    return root, cfg, trainer


@pytest.fixture
def restore_logging():
    handlers = logging.root.handlers[:]
    yield
    logging.root.handlers[:] = handlers


def _write(path, cfg):
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_train_resume_then_predict(first_run, monkeypatch, restore_logging):
    root, cfg, first = first_run
    monkeypatch.chdir(root)
    run = root / "runs" / "tiny"
    assert (run / "model_last.pt").exists() and (run / "config.json").exists()
    assert len(list(run.glob("model_best_*.pt"))) == 1
    assert [h["epoch"] for h in first.history] == [0, 1]
    assert np.isfinite(first.history[1]["train"]["total"])
    assert first.history[1]["train_volumes"] == 4
    assert first.history[1]["train_s"] > 1e-3 * sum(first.clock.ms) > 0
    assert first.scheduler.last_epoch == 2 and len(first.clock.ms) == 2
    last = torch.load(run / "model_last.pt", weights_only=True)
    assert last["epoch"] == 1 and set(last) >= {"optimizer", "scheduler"}

    # one more epoch: --auto_resume picks model_last up at epoch 1
    cfg = copy.deepcopy(cfg)
    cfg["trainer"]["epochs"] = 2
    second = train.main(["--config", _write(root / "tiny.yaml", cfg),
                         "--device", "cpu", "--auto_resume"])
    assert [h["epoch"] for h in second.history] == [2]
    assert second.scheduler.last_epoch == 4
    assert all(int(st["step"]) == 4
               for st in second.optimizer.state.values())
    assert torch.load(run / "model_last.pt", weights_only=True)["epoch"] == 2

    # serving restores the best checkpoint of the run
    inputs = write_ct_volumes(root, [(40, 36, 20)], seed=2)
    records = predict.main(["--run", "tiny", "--input", *inputs,
                            "--device", "cpu"])
    dets = records[0]["detections"]
    assert sorted(d["class"] for d in dets) == list(range(1, 7))
    best = ckpt_lib.pick_checkpoint(run)
    assert best.name.startswith("model_best")
    model = predict.load_predictor(run, device="cpu")[1]
    for name, value in ckpt_lib.load_checkpoint(best).items():
        torch.testing.assert_close(model.state_dict()[name], value)


def test_resume_refuses_weights_only_file(first_run, monkeypatch,
                                          restore_logging):
    root, cfg, first = first_run
    monkeypatch.chdir(root)
    weights = ckpt_lib.save_checkpoint(root / "runs" / "w", "model_last",
                                       first._model)
    with pytest.raises(ValueError, match="weights only"):
        train.main(["--config", _write(root / "tiny.yaml", cfg),
                    "--device", "cpu", "--resume", str(weights)])


def _check_host_augmented(trainer, cases):
    loader = trainer._train_loader
    assert isinstance(loader, HostAugmentingLoader)
    assert isinstance(loader._loader, NativeLoader)
    assert loader._loader.served == len(loader.case_ms) == cases


def _predict(root, run, organs):
    inputs = write_ct_volumes(root, [(40, 36, 20)], seed=2)
    dets = predict.main(["--run", run, "--input", *inputs,
                         "--device", "cpu"])[0]["detections"]
    assert sorted(d["class"] for d in dets) == list(range(1, organs + 1))


def test_flagship_host_augmentation_train_test_predict(
        tmp_path, monkeypatch, restore_logging):
    """The shipped setting (host augmentation, 2 loader threads) -> the
    native loader and the host augmenter on every case -> checkpoint ->
    test --val with both exports -> results_val.json -> predict."""
    cfg = tiny_flagship_config()
    assert cfg["augmentation"]["use_augmentation"]
    assert not cfg["augmentation"]["on_device"]
    cfg["augmentation"].update(p_rotate=1.0, p_intensity_shift=1.0)
    cfg["trainer"]["num_workers"] = 2
    cfg, data_dir = _setup(tmp_path, monkeypatch, cfg, "tinyaug")
    trainer = train.main(["--config", _write(tmp_path / "t.yaml", cfg),
                          "--device", "cpu"])
    _check_host_augmented(trainer, 4)
    assert trainer._train_loader._ahead == 2  # as many cases as threads
    assert np.isfinite(trainer.history[-1]["train"]["total"])
    assert isinstance(trainer._val_loader, NativeLoader)

    scores = test.main(["--run", "tinyaug", "--val", "--save_preds",
                        "--save_attn_map", "--device", "cpu",
                        "--data_dir", data_dir])
    run = tmp_path / "runs" / "tinyaug"
    assert load_json(run / "results_val.json") == scores
    assert np.isfinite(scores["mAP_coco"]) and np.isfinite(
        scores["mAP_nndet"])
    preds = sorted(p.name for p in (run / "predictions_val").iterdir())
    assert len(preds) == 6 and preds[0].endswith("_gt.ply")
    maps = list((run / "attn_maps_val").rglob("*.png"))
    # per case: the affinity map + every 5th frame of 32 (7), attention and
    # segmentation, of 6 organs
    assert len(maps) == 2 * (1 + 6 * 7 * 2)
    _predict(tmp_path, "tinyaug", cfg["neck"]["num_organs"])


def test_one_batch_at_a_time_and_loop_clock(tmp_path, monkeypatch,
                                            restore_logging):
    """``train.train(..., _host_ahead=0)`` keeps no case in flight beyond
    the batch handed out (the JAX package's design) over the same cases;
    the loop clock holds each step's host times, inside the loop's wall
    time."""
    cfg = tiny_flagship_config()
    cfg["trainer"]["num_workers"] = 2
    cfg, data_dir = _setup(tmp_path, monkeypatch, cfg, "onebatch")
    config = validate_config(get_config(_write(tmp_path / "o.yaml", cfg),
                                        dataset_dir=data_dir))
    trainer = train.train(config, argparse.Namespace(
        device="cpu", data_dir=data_dir, resume=None, auto_resume=False),
        _host_ahead=0)
    _check_host_augmented(trainer, 4)
    assert trainer._train_loader._ahead == 0
    clock = trainer.clock
    assert len(clock.ms) == len(clock.start_s) == 2
    for times in (clock.step_host_ms, clock.loader_ms, clock.copy_ms):
        assert len(times) == 2 and min(times) >= 0
    assert clock.start_s[0] < clock.start_s[1]
    host_ms = sum(clock.step_host_ms + clock.loader_ms + clock.copy_ms)
    assert 0 < host_ms <= 1e3 * trainer.history[-1]["train_s"]


def test_swin_host_augmentation_train_test_predict(
        tmp_path, monkeypatch, restore_logging):
    cfg = tiny_swin_config()
    assert cfg["augmentation"]["use_augmentation"]
    assert not cfg["augmentation"]["on_device"]
    cfg["trainer"]["num_workers"] = 2
    cfg, data_dir = _setup(tmp_path, monkeypatch, cfg, "swinaug",
                           num_train=2)
    trainer = train.main(["--config", _write(tmp_path / "s.yaml", cfg),
                          "--device", "cpu"])
    _check_host_augmented(trainer, 2)
    scores = test.main(["--run", "swinaug", "--val", "--device", "cpu",
                        "--data_dir", data_dir])
    assert np.isfinite(scores["mAP_coco"])
    assert (tmp_path / "runs" / "swinaug" / "results_val.json").exists()
    _predict(tmp_path, "swinaug", cfg["neck"]["num_organs"])


def test_on_device_augmentation_step(tmp_path, monkeypatch, restore_logging):
    """One step with augmentation.on_device: true: the step augments the
    device batch from the trainer's generator, no host augmenter."""
    cfg = tiny_flagship_config()
    cfg["augmentation"].update(on_device=True, p_rotate=1.0, p_zoom=1.0,
                               p_gaussian_smooth=1.0)
    cfg, _ = _setup(tmp_path, monkeypatch, cfg, "ondev", num_train=2)
    calls = []
    augment = trainer_lib.augment_batch

    def counted(images, labels, generator, *args, **kwargs):
        calls.append(generator)
        return augment(images, labels, generator, *args, **kwargs)

    monkeypatch.setattr(trainer_lib, "augment_batch", counted)
    trainer = train.main(["--config", _write(tmp_path / "d.yaml", cfg),
                          "--device", "cpu"])
    assert not isinstance(trainer._train_loader, HostAugmentingLoader)
    assert calls == [trainer._generator]
    assert len(trainer.clock.ms) == 1
    assert np.isfinite(trainer.history[-1]["train"]["total"])


@pytest.mark.parametrize("family", ["seg", "detr", "def_detr"])
def test_family_train_test_predict(tmp_path, monkeypatch, restore_logging,
                                   family):
    """The seg proxy (its CE + dice in the losses) and both DETR necks (the
    set criterion's one host match a step) as shipped -> checkpoint -> test
    --val with the attention export (DETR's dense map per organ; Deformable
    DETR has none) -> predict."""
    cfg = tiny_config(family)
    cfg["trainer"]["num_workers"] = 2
    cfg, data_dir = _setup(tmp_path, monkeypatch, cfg, family, num_train=2)
    trainer = train.main(["--config", _write(tmp_path / "f.yaml", cfg),
                          "--device", "cpu"])
    _check_host_augmented(trainer, 2)
    losses = trainer.history[-1]["train"]
    assert np.isfinite(losses["total"])
    assert (losses["segdice"] > 0) == (family == "seg")
    if family != "seg":
        # one match for every layer at once, per train and val step
        clock = trainer._criterion.clock
        assert len(clock.solve_ms) == len(clock.wait_ms) == 1 + 2 * 1
    scores = test.main(["--run", family, "--val", "--save_attn_map",
                        "--device", "cpu", "--data_dir", data_dir])
    assert np.isfinite(scores["mAP_coco"])
    maps = list((tmp_path / "runs" / family).glob("attn_maps_val/**/*.png"))
    # per case: the focused neck's affinity map, and every 5th of 32 frames
    # (7), attention and segmentation, of 6 organs
    want = {"seg": 2 * (1 + 6 * 7 * 2), "detr": 2 * 6 * 7 * 2,
            "def_detr": 0}[family]
    assert len(maps) == want
    _predict(tmp_path, family, cfg["neck"]["num_organs"])


@pytest.mark.parametrize("family", ["retina", "retina_unet"])
def test_retina_train_validate_test(tmp_path, monkeypatch, restore_logging,
                                    family):
    """RetinaNet and Retina U-Net as retina_amos ships them (host
    augmentation, loader threads) -> the validations decoded with the
    NMS -> checkpoint -> test --val; Retina U-Net with
    ``grad_accum_steps: 2`` (one update from its two steps); predict
    refuses the run, as scripts/predict.py has no RetinaNet decode."""
    cfg = tiny_config(family)
    cfg["trainer"]["num_workers"] = 2
    if family == "retina_unet":
        cfg["trainer"]["grad_accum_steps"] = 2
    cfg, data_dir = _setup(tmp_path, monkeypatch, cfg, family)
    trainer = train.main(["--config", _write(tmp_path / "r.yaml", cfg),
                          "--device", "cpu"])
    _check_host_augmented(trainer, 4)
    losses = trainer.history[-1]["train"]
    assert np.isfinite(losses["total"]) and losses["cls"] > 0
    assert (losses["segdice"] > 0) == (family == "retina_unet")
    assert [h["epoch"] for h in trainer.history if "metrics" in h] == [0, 1]
    assert all(np.isfinite(h["metrics"]["mAP_coco"])
               for h in trainer.history if "metrics" in h)
    steps = 1 if family == "retina_unet" else 2
    assert trainer.scheduler.last_epoch == steps
    scores = test.main(["--run", family, "--val", "--device", "cpu",
                        "--data_dir", data_dir])
    assert np.isfinite(scores["mAP_coco"])
    with pytest.raises(ValueError, match="scripts/predict.py"):
        predict.main(["--run", family, "--input", "x.nii.gz", "--device",
                      "cpu"])
