"""Host-side dataset over preprocessed .npy cases (copy of
``transoar_tpu/data/dataset.py``'s numpy loader; the tests pin it).

Layout ``dataset/<name>/<split>/<case>/{data,label}.npy``, as the reference.
The loaders only stack numpy arrays; the boxes are derived from the labels
on the device in the train step (``training/trainer.derive_targets``).
Layout is channels-last ``[S0, S1, S2, 1]``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


class TransoarDataset:
    """Lists and loads preprocessed cases for one split."""

    def __init__(self, config, split, data_dir=None):
        assert split in ("train", "val", "test")
        self._config = config
        self._split = split
        root = Path(data_dir) if data_dir else Path.cwd() / "dataset"
        self._path = root / config["dataset"] / split
        if not self._path.exists():
            raise FileNotFoundError(f"dataset split not found: {self._path}")
        self._cases = sorted(p.name for p in self._path.iterdir()
                             if p.is_dir())
        self._overfit = bool(config.get("overfit"))

    def __len__(self):
        return len(self._cases)

    @property
    def cases(self):
        return list(self._cases)

    @property
    def path(self):
        return self._path

    @property
    def overfit(self):
        return self._overfit

    def __getitem__(self, idx):
        if self._overfit:  # reference dataset.py:28-29
            idx = 0
        case_dir = self._path / self._cases[idx]
        image = np.load(case_dir / "data.npy")
        label = np.load(case_dir / "label.npy")
        # accept both [S0,S1,S2] and channel-first [1,S0,S1,S2] layouts
        if image.ndim == 4:
            image = image[0]
        if label.ndim == 4:
            label = label[0]
        return image.astype(np.float32)[..., None], label.astype(np.int32)


class Loader:
    """Epoch iterator producing fixed-shape numpy batches: the last partial
    batch is dropped, as the reference (dataloader.py:22); shuffling is
    seeded per epoch for reproducibility.

    ``rows`` (multi-GPU input sharding): the positions within each global
    batch this process loads (``parallel.mesh.local_batch_rows``). The
    shuffle is seeded alike on every process, so the ranks' rows together
    are the one-process epoch, each rank reading only its own."""

    def __init__(self, dataset, batch_size, shuffle=False, seed=0,
                 rows=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self.rows = None if rows is None else np.asarray(rows, dtype=np.int64)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1

        for start in range(0, n - n % self.batch_size, self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.rows is not None:
                idx = idx[self.rows]
            images, labels = zip(*(self.dataset[int(i)] for i in idx))
            yield {
                "image": np.stack(images),
                "seg": np.stack(labels),
                "index": idx.astype(np.int32),
            }


def get_loader(config, split, data_dir=None, batch_size=None, rows=None):
    """Reference-compatible entry point: a loader over
    ``<data_dir or ./dataset>/<config['dataset']>/<split>`` at the config's
    batch size (or ``batch_size``), shuffled and seeded per epoch from the
    config's seed for the train split. With ``trainer.num_workers > 0`` it
    is the native C++ loader with that many reader threads (built with
    ``g++`` at first use; a failed build raises), else the Python loader.
    ``rows`` (this process's rows of each global batch) forces the Python
    loader, as in the JAX package: the native loader streams whole
    batches."""
    tcfg = config["trainer"]
    batch_size = batch_size or tcfg["batch_size"]
    shuffle = split == "train" and tcfg.get("shuffle", True)
    dataset = TransoarDataset(config, split, data_dir=data_dir)
    seed = config.get("seed", 0)
    num_workers = int(tcfg.get("num_workers", 0))
    if num_workers > 0 and rows is None:
        from transoar_tpu_torch.native.native_loader import NativeLoader

        logger.info("%s loader: native, %d threads", split, num_workers)
        return NativeLoader(dataset, batch_size, shuffle=shuffle, seed=seed,
                            n_threads=num_workers)
    logger.info("%s loader: python", split)
    return Loader(dataset, batch_size, shuffle=shuffle, seed=seed, rows=rows)
