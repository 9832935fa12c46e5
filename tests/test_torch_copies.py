"""The port's copies of the JAX package's host-side modules against their
originals, on the same inputs: NIfTI I/O, config I/O, anchors, presets,
the synthetic dataset, the loader and the evaluator. Every copy must agree
exactly (same numpy code)."""

import gzip
import json
import logging

import numpy as np
import pytest

from tests.helpers import tiny_config
from transoar_tpu import presets as jpresets
from transoar_tpu.data import dataset as jdataset
from transoar_tpu.data import nifti as jnifti
from transoar_tpu.data import synthetic as jsynthetic
from transoar_tpu.eval import evaluator as jevaluator
from transoar_tpu.models import anchors as janchors
from transoar_tpu.utils import io as jio
from transoar_tpu_torch import presets
from transoar_tpu_torch.data import dataset, nifti, synthetic
from transoar_tpu_torch.eval import evaluator
from transoar_tpu_torch.models import anchors
from transoar_tpu_torch.utils import io


@pytest.mark.parametrize("suffix,dtype", [(".nii.gz", np.int16),
                                          (".nii", np.float32)])
def test_nifti_round_trip_both_ways(tmp_path, rng, suffix, dtype):
    vol = (rng.normal(size=(7, 5, 4)) * 100).astype(dtype)
    affine = np.diag([-0.8, 1.2, -2.5, 1.0])
    affine[:3, 3] = (10.0, -4.0, 3.0)
    ours, ref = tmp_path / f"a{suffix}", tmp_path / f"b{suffix}"
    nifti.write_nifti(vol, ours, affine=affine)
    jnifti.write_nifti(vol, ref, affine=affine)
    # the gzip header names the file: compare what it holds
    read = gzip.open if suffix.endswith(".gz") else open
    with read(ours, "rb") as f, read(ref, "rb") as g:
        assert f.read() == g.read()
    a, b = nifti.load_nifti(ref), jnifti.load_nifti(ours)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    for x, y in zip(nifti.reorient_ras(a["data"], a["affine"]),
                    jnifti.reorient_ras(a["data"], a["affine"])):
        np.testing.assert_array_equal(x, y)


def test_config_io_matches(tmp_path):
    assert io.PATH_TO_CONFIG == jio.PATH_TO_CONFIG
    assert io.get_config("foc_dec_amos") == jio.get_config("foc_dec_amos")
    assert io.load_yaml(io.PATH_TO_CONFIG / "foc_dec_amos.yaml") == \
        jio.load_yaml(io.PATH_TO_CONFIG / "foc_dec_amos.yaml")
    # a dataset's data_info.json is merged in
    cfg = tiny_config()
    cfg["dataset"] = "ds"
    (tmp_path / "ds").mkdir()
    io.write_json({"num_classes": 3, "extra": [1, 2]},
                  tmp_path / "ds" / "data_info.json")
    assert io.load_json(tmp_path / "ds" / "data_info.json") == \
        jio.load_json(tmp_path / "ds" / "data_info.json")
    path = tmp_path / "tiny.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    ours = io.get_config(str(path), dataset_dir=tmp_path)
    assert ours == jio.get_config(str(path), dataset_dir=tmp_path)
    assert ours["extra"] == [1, 2]
    log = tmp_path / "logs" / "x.log"
    handlers = logging.root.handlers[:]
    try:
        io.set_root_logger(log)
        logging.getLogger("copies").info("hello")
    finally:
        logging.root.handlers[:] = handlers
    assert "hello" in log.read_text()


@pytest.mark.parametrize("change", [
    lambda c: None,
    lambda c: c["neck"].update(num_queries=20),   # not a multiple
    lambda c: c["neck"].update(num_queries=12),   # 4 per organ
    lambda c: c["augmentation"].update(p_bogus=1),
    lambda c: c.pop("loss_coefs"),
])
def test_validate_config_matches(change):
    ours, ref = tiny_config(), tiny_config()
    change(ours)
    change(ref)
    try:
        want = jio.validate_config(ref)
    except (KeyError, ValueError) as err:
        with pytest.raises(type(err)):
            io.validate_config(ours)
    else:
        assert io.validate_config(ours) == want


@pytest.mark.parametrize("qpo,dynamic", [(1, True), (7, True), (27, True),
                                         (27, False)])
def test_anchors_match(qpo, dynamic):
    props = anchors.synthetic_bbox_props(4, seed=qpo)
    assert props == janchors.synthetic_bbox_props(4, seed=qpo)
    neck = {"num_queries": 4 * qpo, "num_organs": 4,
            "anchor_gen_dynamic_offset": dynamic, "anchor_gen_offset": 0.1}
    for ours, ref in zip(anchors.generate_anchors(neck, props),
                         janchors.generate_anchors(neck, props)):
        np.testing.assert_array_equal(ours, ref)


def test_presets_match():
    assert presets.flagship_config() == jpresets.flagship_config()
    assert presets.flagship_config(2, (64, 64, 32)) == \
        jpresets.flagship_config(2, (64, 64, 32))
    assert presets.tiny_flagship_config() == jpresets.tiny_flagship_config()
    cfg = tiny_config()
    for key in ("bbox_properties", "labels"):
        cfg.pop(key)
    cfg["dataset_config"] = "dataset_amos"
    assert presets.fill_synthetic_stats(cfg, seed=4) == \
        jpresets.fill_synthetic_stats(cfg, seed=4)


def test_synthetic_dataset_and_loader_match(tmp_path):
    kw = dict(name="syn", shape=(24, 20, 16), num_classes=3, num_train=3,
              num_val=2, num_test=1, seed=5)
    ours = synthetic.generate_dataset(tmp_path / "a", **kw)
    ref = jsynthetic.generate_dataset(tmp_path / "b", **kw)
    files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(ours) for p in ours.rglob("*")
                           if p.is_file())
    for f in files:
        assert (ours / f).read_bytes() == (ref / f).read_bytes(), f

    cfg = tiny_config(num_organs=3)
    cfg["dataset"] = "syn"
    cfg["trainer"].update(batch_size=2, num_workers=0)
    for split in ("train", "val"):
        mine = dataset.get_loader(cfg, split, data_dir=tmp_path / "a")
        theirs = jdataset.get_loader(cfg, split, data_dir=tmp_path / "b")
        assert len(mine) == len(theirs) == 1
        for _ in range(2):  # two epochs: the per-epoch shuffle agrees
            for x, y in zip(mine, theirs):
                assert x.keys() == y.keys()
                for key in x:
                    np.testing.assert_array_equal(x[key], y[key])


@pytest.mark.parametrize("seed,shape", [(0, (64, 48, 32)), (1, (40, 40, 24)),
                                        (2, (33, 17, 29))])
def test_make_case_matches(seed, shape):
    """The box-restricted ellipsoids give the full-grid original's bits,
    organs clipped at the volume's faces included."""
    props = anchors.synthetic_bbox_props(15, seed=seed)
    mine = synthetic.make_case(np.random.default_rng(seed), shape, props)
    ref = jsynthetic.make_case(np.random.default_rng(seed), shape, props)
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_evaluator_matches(rng):
    cfg = tiny_config(num_organs=4)
    ours, ref = evaluator.build_evaluator(cfg), \
        jevaluator.build_evaluator(cfg)
    for _ in range(3):
        n = 2
        gt = [rng.uniform(0.2, 0.6, size=(4, 6)) for _ in range(n)]
        pred = [g + rng.normal(scale=0.03, size=g.shape) for g in gt]
        gt_classes = [np.array([1, 2, 4]), np.array([1, 2, 3, 4])]
        gt = [g[:len(c)] for g, c in zip(gt, gt_classes)]
        args = (pred, [np.arange(1, 5)] * n,
                [rng.uniform(size=4) for _ in range(n)], gt, gt_classes)
        ours.add(*args)
        ref.add(*args)
    assert ours.eval() == ref.eval()
