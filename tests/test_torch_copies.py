"""The port's copies of the JAX package's host-side modules against their
originals, on the same inputs: NIfTI I/O, config I/O, anchors (the
focused neck's and RetinaNet's), presets,
the synthetic dataset, the loader, the evaluator, the Swin window
helpers, the host augmentation and its loader, the loader's per-process
rows and ``local_batch_rows``, the offline preprocessor and the
visualization writers. Every copy must agree exactly (same numpy
code)."""

import gzip
import json
import logging

import numpy as np
import pytest
import torch

from tests.helpers import tiny_config
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu import presets as jpresets
from transoar_tpu.data import dataset as jdataset
from transoar_tpu.data import nifti as jnifti
from transoar_tpu.data import preprocessor as jpreprocessor
from transoar_tpu.data import synthetic as jsynthetic
from transoar_tpu.data import transforms as jtransforms
from transoar_tpu.eval import evaluator as jevaluator
from transoar_tpu.models import anchors as janchors
from transoar_tpu.models import swin as jswin
from transoar_tpu.utils import io as jio
from transoar_tpu.utils import visualization as jvisualization
from transoar_tpu_torch import presets
from transoar_tpu_torch.data import (dataset, nifti, preprocessor, synthetic,
                                     transforms)
from transoar_tpu_torch.eval import evaluator
from transoar_tpu_torch.models import anchors, swin
from transoar_tpu_torch.utils import io, visualization


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


@pytest.mark.parametrize("patch,levels,scales,ratios", [
    ((32, 32, 16), ["P2", "P3"], [8, 12], [[1, 1, 1], [1.5, 1, 0.8]]),
    ((40, 24, 20), ["P1", "P3", "P4"], [6], [[1, 1, 1]]),
    ((256, 256, 128), ["P2", "P3", "P4"], [16, 24, 32],
     [[1, 1, 1], [1.5, 1, 0.8], [0.8, 1.2, 1.0]]),
])
def test_retina_anchors_match(patch, levels, scales, ratios):
    """RetinaNet's anchors (host numpy), bit-exact: retina_amos's 1,345,536
    among them."""
    from transoar_tpu.models import retina as jretina
    from transoar_tpu_torch.models import retina

    cfg = {"augmentation": {"patch_size": list(patch)},
           "retina": {"levels": levels, "anchor_scales": scales,
                      "anchor_ratios": ratios}}
    ours, counts = retina.build_anchors(cfg)
    ref, ref_counts = jretina.build_anchors(cfg)
    assert counts == ref_counts and ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    level = int(levels[0][-1])
    np.testing.assert_array_equal(
        retina.generate_level_anchors(patch, level, scales, ratios),
        jretina.generate_level_anchors(patch, level, scales, ratios))
    if patch == (256, 256, 128):
        assert len(ours) == 1_345_536


def test_presets_match():
    assert presets.flagship_config() == jpresets.flagship_config()
    assert presets.flagship_config(2, (64, 64, 32)) == \
        jpresets.flagship_config(2, (64, 64, 32))
    assert presets.tiny_flagship_config() == jpresets.tiny_flagship_config()
    # the Swin preset is the config file with the same synthetic statistics
    assert presets.swin_fpn_config(2) == jpresets.fill_synthetic_stats(
        dict(jio.get_config("swin_fpn_visceral"),
             trainer=dict(jio.get_config("swin_fpn_visceral")["trainer"],
                          batch_size=2)))
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


def test_loader_rows_match(tmp_path):
    """``Loader(rows=...)``, each process's rows of every global batch,
    against the JAX package's over two shuffled epochs, for each dp
    rank's rows."""
    synthetic.generate_dataset(tmp_path, name="syn", shape=(16, 12, 8),
                               num_classes=3, num_train=9, num_val=0,
                               num_test=0, seed=2)
    cfg = tiny_config(num_organs=3)
    cfg["dataset"] = "syn"
    cfg["trainer"].update(batch_size=4, num_workers=2, shuffle=True)
    for rows in ([0, 1], [2, 3], [1, 3]):
        mine = dataset.get_loader(cfg, "train", data_dir=tmp_path, rows=rows)
        theirs = jdataset.get_loader(cfg, "train", data_dir=tmp_path,
                                     rows=np.array(rows))
        assert type(mine).__name__ == type(theirs).__name__ == "Loader"
        assert len(mine) == len(theirs) == 2
        for _ in range(2):
            pairs = list(zip(mine, theirs))
            assert len(pairs) == 2
            for x, y in pairs:
                assert x.keys() == y.keys()
                for key in x:
                    np.testing.assert_array_equal(x[key], y[key])


@pytest.mark.parametrize("dp,tp,batch", [(2, 1, 4), (4, 1, 8), (2, 2, 2),
                                         (1, 2, 2), (2, 4, 6)])
def test_local_batch_rows_matches(dp, tp, batch):
    """The port's ``local_batch_rows`` against the index map the JAX
    function reads (``NamedSharding(mesh, P("dp"))`` over the dp x 1 x tp
    CPU mesh), one device a process: rank = dp index * tp + tp index, the
    row-major order of both meshes."""
    import jax
    from types import SimpleNamespace

    from jax.sharding import NamedSharding, PartitionSpec
    from transoar_tpu.parallel import mesh as jmesh
    from transoar_tpu_torch.parallel import mesh

    jm = jmesh.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    index = NamedSharding(jm, PartitionSpec("dp")).devices_indices_map(
        (batch,))
    for rank, dev in enumerate(jm.devices.reshape(-1)):
        want = list(range(*index[dev][0].indices(batch)))
        layout = SimpleNamespace(dp=dp, dp_rank=rank // tp, world=dp * tp)
        assert mesh.local_batch_rows(layout, batch).tolist() == want


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


@pytest.mark.parametrize("spatial,shift", [((10, 10, 8), True),
                                           ((10, 10, 4), True),
                                           ((4, 6, 5), False)])
def test_swin_window_helpers_match(spatial, shift):
    window = (5, 5, 5)
    sh = (2, 2, 2) if shift else (0, 0, 0)
    ws, ss = swin.effective_window(spatial, window, sh)
    assert (ws, ss) == jswin.effective_window(spatial, window, sh)
    np.testing.assert_array_equal(swin.relative_position_index(ws),
                                  jswin.relative_position_index(ws))
    padded = tuple(-(-s // w) * w for s, w in zip(spatial, ws))
    np.testing.assert_array_equal(
        swin.shifted_window_regions(padded, ws, ss),
        jswin.shifted_window_regions(padded, ws, ss))
    x = np.random.default_rng(0).normal(size=(2, *padded, 3))
    windows = swin.window_partition(x, ws)
    np.testing.assert_array_equal(windows, jswin.window_partition(x, ws))
    back = swin.window_reverse(torch.from_numpy(windows), ws, 2, *padded)
    np.testing.assert_array_equal(back.numpy(), x)


def _all_p(p):
    """The shipped augmentation keys with every probability set to p."""
    aug = dict(io.get_config("foc_dec_amos")["augmentation"])
    for key in aug:
        if key.startswith("p_"):
            aug[key] = p
    aug["p_flip"] = p / 2  # each axis its own draw
    return aug


def _same_files(ours, ref):
    files = sorted(q.relative_to(ref) for q in ref.rglob("*") if q.is_file())
    assert files == sorted(q.relative_to(ours) for q in ours.rglob("*")
                           if q.is_file())
    assert files
    for f in files:
        assert (ours / f).read_bytes() == (ref / f).read_bytes(), f


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("p", [1.0, 0.0])
def test_host_augmentation_matches(rng, seed, p):
    image = rng.normal(size=(14, 12, 8, 1)).astype(np.float32)
    label = rng.integers(0, 4, size=(14, 12, 8)).astype(np.int32)
    aug = _all_p(p)
    stats = {"percentile_00_5": -1.5, "percentile_99_5": 2.0}
    for s in (None, stats):
        args = (image.shape[:3], aug)
        for x, y in zip(
                transforms.sample_affine_np(np.random.default_rng(seed),
                                            *args),
                jtransforms.sample_affine_np(np.random.default_rng(seed),
                                             *args)):
            np.testing.assert_array_equal(x, y)
        ours = transforms.augment_case_np(image, label, seed, aug, s)
        ref = jtransforms.augment_case_np(image, label, seed, aug, s)
        for x, y in zip(ours, ref):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    if p == 0.0:  # the window alone
        np.testing.assert_array_equal(ours[1], label)


@pytest.mark.parametrize("ahead", [0, 3])
def test_host_augmenting_loader_matches(tmp_path, ahead):
    """Two epochs of batches over a shuffled split: the same bits as the
    JAX package's loader, one batch at a time or with cases in flight."""
    synthetic.generate_dataset(tmp_path, name="syn", shape=(16, 12, 8),
                               num_classes=3, num_train=5, num_val=0,
                               num_test=0, seed=2)
    cfg = tiny_config(num_organs=3)
    cfg["dataset"] = "syn"
    cfg["trainer"].update(batch_size=2, num_workers=0, shuffle=True)
    aug, stats = _all_p(0.5), {"percentile_00_5": -0.5,
                               "percentile_99_5": 1.5}
    ours = transforms.HostAugmentingLoader(
        dataset.get_loader(cfg, "train", data_dir=tmp_path), aug, stats,
        seed=3, workers=2, ahead=ahead)
    ref = jtransforms.HostAugmentingLoader(
        jdataset.get_loader(cfg, "train", data_dir=tmp_path), aug, stats,
        seed=3, workers=2)
    assert len(ours) == len(ref) == 2
    for _ in range(2):
        pairs = list(zip(ours, ref))
        assert len(pairs) == 2
        for x, y in pairs:
            assert x.keys() == y.keys()
            for key in x:
                np.testing.assert_array_equal(x[key], y[key])
    assert len(ours.case_ms) == 8


def test_preprocessor_matches(tmp_path):
    """The whole PreProcessor on self-written NIfTI cases (a crop, a resize
    off the grid, a case the border filter drops): the same .npy bits and
    the same data_info.json."""
    rng = np.random.default_rng(5)
    raw = tmp_path / "raw"
    for sub in ("imagesTr", "labelsTr"):
        (raw / sub).mkdir(parents=True)
    for i in range(4):
        shape = (30 + 3 * i, 26, 18)
        label = np.zeros(shape, np.int16)
        label[5:15, 6:14, 4:9] = 1
        label[16:24, 13:21, 9:15] = 2
        if i == 3:
            label[0:3, 6:10, 4:8] = 1  # organ 1 on the boundary
        image = label * 90.0 + rng.normal(scale=10, size=shape)
        affine = np.diag([-1.2, 1.0, 2.0, 1.0])
        nifti.write_nifti(image.astype(np.float32),
                          raw / "imagesTr" / f"c{i}.nii.gz", affine=affine)
        nifti.write_nifti(label, raw / "labelsTr" / f"c{i}.nii.gz",
                          affine=affine)
    case = [{"image": f"imagesTr/c{i}.nii.gz",
             "label": f"labelsTr/c{i}.nii.gz", "name": f"c{i}"}
            for i in range(4)]
    splits = {"train": case[:2], "val": case[2:3], "test": case[3:]}
    prep = {"resize_shape": [24, 20, 12], "margin": [2, 2, 2],
            "border_organs": [1, 2]}
    data = {"num_classes": 2, "labels": {"1": "a", "2": "b"},
            "labels_small": {}, "labels_mid": {}, "labels_large": {}}
    preprocessor.PreProcessor(splits, raw, tmp_path / "ours", prep,
                              data).run()
    jpreprocessor.PreProcessor(splits, raw, tmp_path / "ref", prep,
                               data).run()
    _same_files(tmp_path / "ours", tmp_path / "ref")
    assert len(list((tmp_path / "ours" / "train").iterdir())) == 2
    assert not (tmp_path / "ours" / "test").exists()  # c3 filtered out


def test_visualization_writers_match(tmp_path):
    cfg = tiny_config(num_organs=2, qpo=7, patch=(32, 32, 16),
                      input_level="P2")
    rng = np.random.default_rng(0)
    seg = np.zeros((32, 32, 16), np.int32)
    seg[4:12, 4:12, 2:8] = 1
    seg[16:24, 16:24, 8:14] = 2
    boxes = rng.uniform(0.3, 0.6, size=(2, 6)).astype(np.float32)
    out = {"attn_weights": rng.uniform(size=(1, 4, 14, 256))
           .astype(np.float32),
           "self_attn_weights": rng.uniform(size=(1, 14, 14))
           .astype(np.float32),
           "pred_logits": rng.normal(size=(1, 14, 1)).astype(np.float32)}
    for mod, name in ((visualization, "ours"), (jvisualization, "ref")):
        mod.save_pred_visualization(boxes, np.array([1, 2]),
                                    np.array([0.9, 0.4]), boxes[:1],
                                    np.array([1]), seg, tmp_path / name, 3)
        mod.save_attn_visualization(out, cfg, tmp_path / name, 3, seg=seg)
    _same_files(tmp_path / "ours", tmp_path / "ref")
    # the DETR necks' export: head-averaged [Q, S] weights, softmax classes
    detr = {"attn_weights": rng.uniform(size=(1, 10, 256)).astype(np.float32),
            "pred_logits": rng.normal(size=(1, 10, 3)).astype(np.float32)}
    for mod, name in ((visualization, "ours_detr"),
                      (jvisualization, "ref_detr")):
        mod.save_attn_visualization(detr, cfg, tmp_path / name, 4, seg=seg)
    _same_files(tmp_path / "ours_detr", tmp_path / "ref_detr")
    assert len(list((tmp_path / "ours_detr").rglob("*.png"))) == 2 * 7 * 2
