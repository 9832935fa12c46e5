"""ctypes binding + Python iterator for the native C++ case loader (the
port's copy of ``transoar_tpu/native/native_loader.py``).

``loader.cpp`` is compiled with ``g++`` at first use into
``build/transoar_tpu_torch/loader-<hash>.so`` at the root of the checkout,
keyed by a hash of the source and the flags, as the CUDA sources are
(``ops/kernels/_build.py``). Nothing is built when the module is imported,
and a failed build raises: there is no quiet fall back to the Python loader.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from transoar_tpu_torch.ops.kernels._build import BUILD_DIR

SOURCE = Path(__file__).with_name("loader.cpp")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
CAPACITY = 16  # cases read ahead of the one handed out


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"loader-{digest}.so"


@functools.cache
def load_library():
    """Compile ``loader.cpp`` if its build is missing, then load it and
    declare its C interface."""
    so = library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.nl_create.restype = ctypes.c_void_p
    lib.nl_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.nl_set_epoch.restype = None
    lib.nl_set_epoch.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_int64),
                                 ctypes.c_int]
    lib.nl_next.restype = ctypes.c_int64
    lib.nl_next.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_int32)]
    lib.nl_destroy.restype = None
    lib.nl_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeLoader:
    """Threaded prefetching loader over a preprocessed dataset split.

    Yields the same batch dicts as the Python ``data.dataset.Loader``:
    {'image': [B, S0, S1, S2, 1] f32, 'seg': [B, S0, S1, S2] i32,
     'index': [B] i32}, in the same order (the shuffle is seeded per epoch
    from ``seed + epoch``; the last partial batch is dropped). ``served``
    counts the cases handed out.
    """

    def __init__(self, dataset, batch_size, shuffle=False, seed=0,
                 n_threads=8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.served = 0
        self._epoch = 0

        # per-case file paths; the fixed shape from case 0
        image0, _ = dataset[0]
        self._shape = image0.shape[:3]
        voxels = int(np.prod(self._shape))
        img_paths, lbl_paths = [], []
        for case in dataset.cases:
            case_dir = dataset.path / case
            img_paths.append(str(case_dir / "data.npy").encode())
            lbl_paths.append(str(case_dir / "label.npy").encode())

        self._lib = load_library()
        n = len(img_paths)
        paths = ctypes.c_char_p * n
        self._handle = self._lib.nl_create(
            paths(*img_paths), paths(*lbl_paths), n, voxels, n_threads,
            CAPACITY)
        self._n = n

    def __len__(self):
        return self._n // self.batch_size

    def __iter__(self):
        order = np.arange(self._n, dtype=np.int64)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        if self.dataset.overfit:
            order[:] = 0

        self._lib.nl_set_epoch(self._handle,
                               (ctypes.c_int64 * len(order))(*order),
                               len(order))
        bsz = self.batch_size
        for _ in range(len(self)):
            images = np.empty((bsz, *self._shape, 1), np.float32)
            labels = np.empty((bsz, *self._shape), np.int32)
            idx = np.empty(bsz, np.int32)
            for b in range(bsz):
                image = images[b, ..., 0]
                got = self._lib.nl_next(
                    self._handle,
                    image.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    labels[b].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
                if got < 0:
                    raise RuntimeError(f"native loader failure (code {got})")
                idx[b] = got
                self.served += 1
            yield {"image": images, "seg": labels, "index": idx}

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.nl_destroy(self._handle)
            self._handle = None
