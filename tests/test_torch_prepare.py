"""The port's dataset-preparation CLIs against the JAX package's scripts on
self-written NIfTI corpora: ``python -m transoar_tpu_torch.prepare_dataset_
{amos,visceral}`` write the same files, bit for bit, as
``scripts/prepare_dataset_{amos,visceral}.py``."""

import logging
import sys

import numpy as np
import pytest
import yaml

from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu_torch import prepare_dataset_amos, prepare_dataset_visceral
from transoar_tpu_torch.data.nifti import write_nifti
from transoar_tpu_torch.utils.io import get_config, load_json


def _case(rng, shape, organs):
    """Cuboid organs 1..organs of 8 voxels a side inside the volume, away
    from its faces (later organs overlap earlier ones in part)."""
    label = np.zeros(shape, np.int16)
    for k in range(1, organs + 1):
        lo = [3 + (5 * k) % (s - 14) for s in shape]
        label[lo[0]:lo[0] + 8, lo[1]:lo[1] + 8, lo[2]:lo[2] + 8] = k
    image = label * 60.0 + rng.normal(scale=15, size=shape)
    return image.astype(np.float32), label


def _dataset_config(tmp_path, name, **prep):
    cfg = get_config(name)
    cfg["preprocessing"].update(prep)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _run_both(monkeypatch, tmp_path, ours, script, args):
    from importlib import import_module

    handlers = logging.root.handlers[:]
    monkeypatch.chdir(tmp_path)
    try:
        out = ours.main([*args, "--out", str(tmp_path / "ours")])
        monkeypatch.setattr(sys, "argv",
                            ["x", *args, "--out", str(tmp_path / "ref")])
        import_module(f"scripts.{script}").main()
    finally:
        logging.root.handlers[:] = handlers
    files = sorted(p.relative_to(tmp_path / "ref")
                   for p in (tmp_path / "ref").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "ours")
                           for p in (tmp_path / "ours").rglob("*")
                           if p.is_file())
    for f in files:
        assert (tmp_path / "ours" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes(), f
    return out, files


def test_prepare_amos_matches_script(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    for sub in ("imagesTr", "labelsTr"):
        (raw / sub).mkdir(parents=True)
    for i in range(6):
        image, label = _case(rng, (40 + i, 38, 30), organs=15)
        write_nifti(image, raw / "imagesTr" / f"amos_{i:04d}.nii.gz")
        write_nifti(label, raw / "labelsTr" / f"amos_{i:04d}.nii.gz")
    cfg = _dataset_config(tmp_path, "dataset_amos", resize_shape=[32, 32, 24],
                          num_train=3, num_val=2, num_test=1,
                          dataset_name="amos_tiny")
    out, files = _run_both(monkeypatch, tmp_path, prepare_dataset_amos,
                           "prepare_dataset_amos",
                           ["--path_to_dataset", str(raw), "--config", cfg])
    assert out == tmp_path / "ours" / "amos_tiny"
    assert sum(f.name == "data.npy" for f in files) == 6
    assert np.load(next(out.glob("train/*/data.npy"))).shape == (32, 32, 24)
    info = load_json(out / "data_info.json")
    assert info["num_classes"] == 15 and info["bbox_properties"]
    assert info["preprocessing_config"]["border_organs"] == [1, 6, 7, 14, 15]


def test_prepare_visceral_matches_script(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    corpora = {}
    for corpus, n in (("gc", 3), ("sc", 2)):
        root = tmp_path / corpus
        for i in range(n):
            case = root / f"case{i}"
            case.mkdir(parents=True)
            image, label = _case(rng, (36, 34 + i, 40), organs=13)
            write_nifti(image, case / "ct.nii.gz")
            write_nifti(label, case / "ct_seg.nii.gz")
        corpora[corpus] = str(root)
    cfg = _dataset_config(tmp_path, "dataset_visceral",
                          resize_shape=[32, 32, 40],
                          dataset_name="visceral_tiny")
    out, files = _run_both(
        monkeypatch, tmp_path, prepare_dataset_visceral,
        "prepare_dataset_visceral",
        ["--path_to_gc", corpora["gc"], "--path_to_sc", corpora["sc"],
         "--config", cfg])
    assert out == tmp_path / "ours" / "visceral_tiny"
    assert {f.parts[1] for f in files} == {"train", "val", "test",
                                           "data_info.json"}
    assert sum(f.name == "label.npy" for f in files) == 5
    assert len(load_json(out / "data_info.json")["bbox_properties"]) == 13


@pytest.mark.parametrize("cli", [prepare_dataset_amos,
                                 prepare_dataset_visceral])
def test_prepare_refuses_when_every_case_is_filtered(tmp_path, cli):
    """No case passes the filters: no data_info.json of NaN statistics."""
    rng = np.random.default_rng(2)
    image, label = _case(rng, (20, 20, 16), organs=2)  # too few organs
    if cli is prepare_dataset_amos:
        for sub in ("imagesTr", "labelsTr"):
            (tmp_path / "raw" / sub).mkdir(parents=True)
        write_nifti(image, tmp_path / "raw" / "imagesTr" / "a.nii.gz")
        write_nifti(label, tmp_path / "raw" / "labelsTr" / "a.nii.gz")
        args = ["--path_to_dataset", str(tmp_path / "raw")]
    else:
        for corpus in ("gc", "sc"):
            (tmp_path / corpus / "c").mkdir(parents=True)
            write_nifti(image, tmp_path / corpus / "c" / "ct.nii.gz")
            write_nifti(label, tmp_path / corpus / "c" / "ct_seg.nii.gz")
        args = ["--path_to_gc", str(tmp_path / "gc"),
                "--path_to_sc", str(tmp_path / "sc")]
    handlers = logging.root.handlers[:]
    try:
        with pytest.raises(RuntimeError, match="zero cases"):
            cli.main([*args, "--out", str(tmp_path / "out")])
    finally:
        logging.root.handlers[:] = handlers
    assert not list((tmp_path / "out").rglob("data_info.json"))
