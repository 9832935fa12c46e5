"""Host-side dataset over preprocessed .npy cases (copy of
``transoar_tpu/data/dataset.py``'s numpy loader; the tests pin it).

Layout ``dataset/<name>/<split>/<case>/{data,label}.npy``, as the reference.
The loader only stacks numpy arrays; the boxes are derived from the labels
on the device in the train step (``training/trainer.derive_targets``).
Layout is channels-last ``[S0, S1, S2, 1]``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


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
    seeded per epoch for reproducibility."""

    def __init__(self, dataset, batch_size, shuffle=False, seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

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
            images, labels = zip(*(self.dataset[int(i)] for i in idx))
            yield {
                "image": np.stack(images),
                "seg": np.stack(labels),
                "index": idx.astype(np.int32),
            }


def get_loader(config, split, data_dir=None):
    """Reference-compatible entry point: the in-process loader over
    ``<data_dir or ./dataset>/<config['dataset']>/<split>`` at the config's
    batch size (shuffled, seeded per epoch from the config's seed, for the
    train split). ``trainer.num_workers`` is accepted and not used: the JAX
    package's threaded C++ loader is not ported."""
    tcfg = config["trainer"]
    shuffle = split == "train" and tcfg.get("shuffle", True)
    dataset = TransoarDataset(config, split, data_dir=data_dir)
    return Loader(dataset, tcfg["batch_size"], shuffle=shuffle,
                  seed=config.get("seed", 0))
