"""The port's native C++ loader (``transoar_tpu_torch/native``): built with
g++ into ``build/transoar_tpu_torch/``, it yields the same batches as the
port's Python ``Loader`` and as the JAX package's ``NativeLoader``,
shuffled and not; ``get_loader`` takes it when ``trainer.num_workers > 0``
and raises when it cannot be built."""

import numpy as np
import pytest

from tests.helpers import tiny_config
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.data.dataset import TransoarDataset as JaxDataset
from transoar_tpu.native.native_loader import NativeLoader as JaxNative
from transoar_tpu_torch.data import dataset
from transoar_tpu_torch.data.synthetic import generate_dataset
from transoar_tpu_torch.native import native_loader
from transoar_tpu_torch.ops.kernels._build import BUILD_DIR


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    generate_dataset(root, name="syn", shape=(16, 12, 8), num_classes=2,
                     num_train=5, num_val=2, num_test=0, seed=1)
    cfg = tiny_config(num_organs=2, qpo=1, patch=(16, 12, 8))
    cfg["dataset"] = "syn"
    return root, cfg


@pytest.mark.parametrize("shuffle", [False, True])
def test_native_matches_python_and_jax(split, shuffle):
    root, cfg = split
    ds = dataset.TransoarDataset(cfg, "train", data_dir=root)
    loaders = [native_loader.NativeLoader(ds, 2, shuffle=shuffle, seed=3,
                                          n_threads=3),
               dataset.Loader(ds, 2, shuffle=shuffle, seed=3),
               JaxNative(JaxDataset(cfg, "train", data_dir=root), 2,
                         shuffle=shuffle, seed=3, n_threads=2)]
    assert [len(loader) for loader in loaders] == [2, 2, 2]
    for epoch in range(2):  # the per-epoch shuffle agrees too
        batches = [list(loader) for loader in loaders]
        assert len(batches[0]) == 2
        for ours, *others in zip(*batches):
            for other in others:
                assert ours.keys() == other.keys()
                for key in ours:
                    assert ours[key].dtype == other[key].dtype
                    np.testing.assert_array_equal(ours[key], other[key])
    assert loaders[0].served == 2 * 4  # drop_last: 4 of 5 cases an epoch


def test_get_loader_takes_native_with_workers(split):
    root, cfg = split
    cfg = dict(cfg, trainer=dict(cfg["trainer"], num_workers=2))
    loader = dataset.get_loader(cfg, "train", data_dir=root)
    assert isinstance(loader, native_loader.NativeLoader)
    assert native_loader.library_path().parent == BUILD_DIR
    assert native_loader.library_path().exists()
    cfg["trainer"]["num_workers"] = 0
    assert isinstance(dataset.get_loader(cfg, "train", data_dir=root),
                      dataset.Loader)


def test_failed_build_raises(split, tmp_path, monkeypatch):
    """No quiet fall back to the Python loader: a source g++ refuses
    raises, through get_loader too."""
    root, cfg = split
    broken = tmp_path / "loader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", broken)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    native_loader.load_library.cache_clear()
    try:
        cfg = dict(cfg, trainer=dict(cfg["trainer"], num_workers=2))
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            dataset.get_loader(cfg, "train", data_dir=root)
    finally:
        native_loader.load_library.cache_clear()
