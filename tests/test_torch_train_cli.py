"""The port's train CLI on the CPU, on a tiny synthetic dataset: train ->
checkpoints -> ``--auto_resume`` -> ``predict`` from the run directory
(``chip_smoke.py``'s training phase, rehearsed at tiny size)."""

import logging

import numpy as np
import pytest
import torch
import yaml

from transoar_tpu_torch import predict, train
from transoar_tpu_torch.data.synthetic import generate_dataset
from transoar_tpu_torch.presets import tiny_flagship_config, write_ct_volumes
from transoar_tpu_torch.training import checkpoints as ckpt_lib


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    """A tiny flagship config on disk over a 4 + 2 case synthetic dataset;
    cwd is the run root. Restores the root logger the CLI reconfigures."""
    cfg = tiny_flagship_config()
    for key in ("bbox_properties", "labels", "labels_small", "labels_mid",
                "labels_large"):
        cfg.pop(key)  # the dataset's data_info.json provides them
    cfg.update(dataset="syn", experiment_name="tiny", debug_mode=False)
    cfg["augmentation"]["use_augmentation"] = False
    cfg["trainer"].update(epochs=1, batch_size=2)
    generate_dataset(tmp_path / "dataset", name="syn",
                     shape=tuple(cfg["augmentation"]["patch_size"]),
                     num_classes=cfg["neck"]["num_organs"], num_train=4,
                     num_val=2, num_test=0, seed=1)
    monkeypatch.chdir(tmp_path)
    handlers = logging.root.handlers[:]
    yield tmp_path, cfg
    logging.root.handlers[:] = handlers


def _write(path, cfg):
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_train_resume_then_predict(run_dir):
    root, cfg = run_dir
    args = ["--config", _write(root / "tiny.yaml", cfg), "--device", "cpu"]
    first = train.main(args)
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


def test_resume_refuses_weights_only_file(run_dir):
    root, cfg = run_dir
    first = train.main(["--config", _write(root / "tiny.yaml", cfg),
                        "--device", "cpu"])
    weights = ckpt_lib.save_checkpoint(root / "runs" / "w", "model_last",
                                       first._model)
    with pytest.raises(ValueError, match="weights only"):
        train.main(["--config", _write(root / "tiny.yaml", cfg),
                    "--device", "cpu", "--resume", str(weights)])


def test_host_augmentation_is_not_ported(run_dir):
    root, cfg = run_dir
    cfg["augmentation"]["use_augmentation"] = True
    with pytest.raises(NotImplementedError, match="Queue 1, item 2"):
        train.main(["--config", _write(root / "tiny.yaml", cfg),
                    "--device", "cpu"])
