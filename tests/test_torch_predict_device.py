"""The serving path that prepares a volume on the device
(``predict.prepare_on_device``: the raw voxels uploaded, then cast, scaled,
reoriented to RAS and resized there) against the host path
(``predict.prepare_volume``: ``load_nifti``, ``reorient_ras``, scipy zoom).

The equivalence cases run on the CPU here and, marked ``cuda``, on a card:

    python -m pytest --noconftest -q -m cuda tests/test_torch_predict_device.py

Tolerance: the resample is f32 trilinear on the device path and a double
interpolation rounded to f32 on the host. Where each in / out extent ratio
is dyadic, as on the served grid (512 -> 256 in-plane, 96-176 -> 128
slices), the f32 source coordinates are exact and the paths differ by the
blend's rounding alone: 1e-6 of the volume's largest magnitude. Off such
ratios (``odd_grid``) the f32 coordinates carry a few ulps of the input
extent, which move a sample by that fraction of its neighbours' difference:
2**-20 x the largest extent x the volume's range.
"""

from __future__ import annotations

import contextlib
import struct

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu_torch import predict, presets
from transoar_tpu_torch.data.nifti import write_nifti

SHAPE = (40, 36, 20)
TARGET = (32, 24, 16)  # in / out ratios 1.25, 1.5, 1.25


def _lps():
    affine = np.diag([-0.8, -0.8, 2.5, 1.0])
    affine[:3, 3] = (120.0, 110.0, -150.0)
    return affine


def _permuted():
    """Voxel axes (x, y, z) along world (A, S, R), two of them reversed."""
    return np.array([[0.0, 0.0, -2.5, 30.0], [0.8, 0.0, 0.0, -12.0],
                     [0.0, -0.9, 0.0, 7.5], [0.0, 0.0, 0.0, 1.0]])


def _int16(rng):
    return rng.integers(-1024, 2000, size=SHAPE).astype(np.int16)


# name -> (volume, affine, suffix, (scl_slope, scl_inter) | None, target)
CASES = {
    "lps_int16": (_int16, _lps, ".nii.gz", None, TARGET),
    "float32": (lambda rng: rng.normal(0.4, 0.6, SHAPE).astype(np.float32),
                lambda: np.diag([1.5, 1.5, 2.0, 1.0]), ".nii.gz", None,
                TARGET),
    # RAS (20, 40, 36): ratios 1.25, 1.25, 1.5
    "permuted_axes": (_int16, _permuted, ".nii.gz", None, (16, 32, 24)),
    "scl_slope_inter": (_int16, _lps, ".nii", (0.5, -1024.0), TARGET),
    "time_axis": (lambda rng: _int16(rng)[..., None], _lps, ".nii.gz", None,
                  TARGET),
    "uint16": (lambda rng: rng.integers(0, 4000, SHAPE).astype(np.uint16),
               _lps, ".nii.gz", None, TARGET),
    "odd_grid": (_int16, _permuted, ".nii.gz", None, (24, 20, 12)),
}


def _write(case, folder):
    volume, affine, suffix, scl, target = CASES[case]
    path = folder / f"{case}{suffix}"
    write_nifti(volume(np.random.default_rng(7)), path, affine=affine())
    if scl is not None:  # write_nifti leaves slope 1, intercept 0
        with open(path, "r+b") as f:
            f.seek(112)
            f.write(struct.pack("<2f", *scl))
    return path, target


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("case", list(CASES))
def test_device_path_matches_host_path(case, device, tmp_path):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path, target = _write(case, tmp_path)
    image, ras_shape, affine = predict.prepare_on_device(path, target, device)
    want, ras, want_affine = predict.prepare_volume(path, target)

    assert image.device.type == device and image.dtype == torch.float32
    assert ras_shape == ras.shape
    np.testing.assert_array_equal(affine, want_affine)
    got = image.cpu().numpy()
    assert got.shape == want.shape == (1, *target, 1)
    if case == "odd_grid":
        atol = 2.0 ** -20 * max(ras.shape) * float(np.ptp(ras))
    else:
        atol = 1e-6 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_device_path_spans(tmp_path, monkeypatch):
    """The device path marks its three host phases, in order (recorded
    through a stand-in for ``span``: a profiler's start costs seconds)."""
    path, target = _write("lps_int16", tmp_path)
    names = []

    def record(name):
        names.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(predict, "span", record)
    predict.prepare_on_device(path, target, "cpu")
    assert names == ["predict.read", "predict.reorient", "predict.resize"]


def _stub_forward(images):
    """A forward that keeps its input and scores every query alike."""
    def forward(image):
        images.append(image)
        return {"pred_logits": np.zeros((1, 4, 1), np.float32),
                "pred_boxes": np.full((1, 4, 6), 0.5, np.float32)}
    return forward


def test_predict_case_without_a_card_takes_the_host_path(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, target = _write("permuted_axes", tmp_path)
    config = {"neck": {"num_organs": 2},
              "augmentation": {"patch_size": list(target)}}
    images, before = [], dict(predict.prepared)
    dets, _, ras_shape, affine, _ = predict.predict_case(
        path, config, _stub_forward(images))
    assert predict.prepared == {"card": before["card"],
                                "host": before["host"] + 1}
    want, ras, want_affine = predict.prepare_volume(path, target)
    np.testing.assert_array_equal(images[0], want)
    assert ras_shape == ras.shape and len(dets) == 2
    np.testing.assert_array_equal(affine, want_affine)


@pytest.mark.cuda
def test_card_path_serves_as_the_host_path(tmp_path):
    """predict_case with no device takes the card path on a card, and its
    detections match the host path's on the same volume."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = presets.tiny_flagship_config()
    presets.save_random_run(cfg, tmp_path / "run", seed=0)
    config, _, forward = predict.load_predictor(tmp_path / "run",
                                                device="cuda")
    path = presets.write_ct_volumes(tmp_path, [(48, 40, 20)], seed=3)[0]
    outs = []

    def capture(image):
        outs.append(forward(image))
        return outs[-1]

    before = dict(predict.prepared)
    card = predict.predict_case(path, config, capture)
    assert predict.prepared == {"card": before["card"] + 1,
                                "host": before["host"]}
    host = predict.predict_case(path, config, capture, device="cpu")
    assert predict.prepared["host"] == before["host"] + 1

    organs = config["neck"]["num_organs"]
    card_pick, host_pick = (o["pred_logits"][0, :, 0].reshape(organs, -1)
                            .argmax(-1) for o in outs)
    np.testing.assert_array_equal(card_pick, host_pick)
    assert card[2] == host[2]
    np.testing.assert_array_equal(card[3], host[3])
    assert len(card[0]) == len(host[0]) == organs
    for ours, ref in zip(card[0], host[0]):
        assert ours["class"] == ref["class"]
        assert abs(ours["score"] - ref["score"]) <= 1e-4
        np.testing.assert_allclose(ours["box_cxcyczwhd_norm"],
                                   ref["box_cxcyczwhd_norm"], rtol=0,
                                   atol=1e-4)
