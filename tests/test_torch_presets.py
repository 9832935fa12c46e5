"""The port's ready-made runs and requests (transoar_tpu_torch.presets), and
chip_smoke.py's serving phase rehearsed on the CPU at tiny size: seeded
random run -> synthetic NIfTI requests off the grid -> predict.main."""

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.data.nifti import load_nifti
from transoar_tpu_torch import predict
from transoar_tpu_torch.ops.kernels.packed_conv import packed_conv
from transoar_tpu_torch.presets import (save_random_run, tiny_flagship_config,
                                        write_ct_volumes)
from transoar_tpu_torch.training import checkpoints as ckpt_lib
from transoar_tpu_torch.utils.weights import random_state_dict

SHAPES = [(40, 36, 20), (28, 30, 12)]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("presets")
    cfg = tiny_flagship_config()
    cfg["foreground_voxel_statistics"] = {"percentile_00_5": -1000.0,
                                          "percentile_99_5": 1000.0}
    ckpt = save_random_run(cfg, root / "runs" / "tiny", seed=3)
    return root, cfg, ckpt


def test_save_random_run_restores_seeded_weights(tiny_run):
    root, cfg, ckpt = tiny_run
    assert ckpt == ckpt_lib.pick_checkpoint(root / "runs" / "tiny")
    assert ckpt_lib.load_run_config(root / "runs" / "tiny")["neck"] == \
        cfg["neck"]
    _, model, _ = predict.load_predictor(root / "runs" / "tiny",
                                         device="cpu")
    want = random_state_dict(model, 3)
    for name, value in model.state_dict().items():
        torch.testing.assert_close(value, want[name], rtol=0, atol=0)
        assert value.abs().max() > 0, name  # no zero-initialised head left


def test_write_ct_volumes_off_the_grid(tmp_path):
    paths = write_ct_volumes(tmp_path, SHAPES, seed=1)
    assert [p.rsplit("/", 1)[-1] for p in paths] == ["case0.nii.gz",
                                                     "case1.nii.gz"]
    for path, shape in zip(paths, SHAPES):
        img = load_nifti(path)
        assert img["data"].shape == shape
        assert img["data"].min() < -900 and img["data"].max() > 0
        assert np.all(np.diag(img["affine"])[:2] < 0)  # LPS: reorient runs
        image, ras, _ = predict.prepare_volume(path, (32, 32, 16))
        assert image.shape == (1, 32, 32, 16, 1) and ras.shape == shape


def test_serving_rehearsal_on_cpu(tiny_run, monkeypatch):
    root, cfg, _ = tiny_run
    inputs = write_ct_volumes(root, SHAPES, seed=2)
    monkeypatch.chdir(root)
    before = packed_conv.launches
    records = predict.main(["--run", "tiny", "--input", *inputs,
                            "--device", "cpu"])
    assert packed_conv.launches == before  # the CPU runs the plain version
    organs = cfg["neck"]["num_organs"]
    assert len(records) == len(SHAPES)
    for rec in records:
        dets = rec["detections"]
        assert sorted(d["class"] for d in dets) == list(range(1, organs + 1))
        scores = np.array([d["score"] for d in dets])
        boxes = np.array([d["box_cxcyczwhd_norm"] for d in dets])
        assert np.isfinite(scores).all() and np.isfinite(boxes).all()
        assert boxes.min() >= 0.0 and boxes.max() <= 1.0
        assert np.ptp(scores) > 0  # seeded heads: the organs score apart
        assert rec["forward_s"] > 0 and rec["total_s"] >= rec["forward_s"]
