"""VISCERAL dataset preparation (twin of
``scripts/prepare_dataset_visceral.py``):

    python -m transoar_tpu_torch.prepare_dataset_visceral \
        --path_to_gc <gold corpus dir> --path_to_sc <silver corpus dir> \
        [--config dataset_visceral] [--out D]

Each corpus directory holds one subdirectory per case with an image and a
label NIfTI; the shorter path is the image (the reference's length sort,
transoar/utils/io.py:80). After a seeded shuffle the gold corpus splits
into val / test halves and the silver corpus is the train set
(reference prepare_dataset_visceral.py:36-39); then the ``PreProcessor``
writes ``<out or ./dataset>/<preprocessing.dataset_name>/``. Host only.
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

from transoar_tpu_torch.data.preprocessor import PreProcessor
from transoar_tpu_torch.prepare_dataset_amos import DATA_KEYS
from transoar_tpu_torch.utils.io import get_config, set_root_logger


def collect_cases(corpus_root: Path):
    """Cases with absolute paths: the two corpora have different roots."""
    cases = []
    for case_dir in sorted(p for p in corpus_root.iterdir() if p.is_dir()):
        files = sorted(case_dir.glob("*.nii*"), key=lambda p: len(str(p)))
        if len(files) >= 2:
            cases.append({"image": str(files[0]), "label": str(files[1]),
                          "name": case_dir.name})
    return cases


def main(argv=None):
    """Prepare the dataset; returns the output directory."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--path_to_gc", required=True,
                        help="Gold corpus (val/test).")
    parser.add_argument("--path_to_sc", required=True,
                        help="Silver corpus (train).")
    parser.add_argument("--config", default="dataset_visceral",
                        help="Dataset config in ./config, or a .yaml path.")
    parser.add_argument("--out", default=None,
                        help="Output root (default ./dataset).")
    args = parser.parse_args(argv)

    set_root_logger(Path.cwd() / "logs" / "prepare_dataset.log")
    config = get_config(args.config)
    prep = config["preprocessing"]

    rng = random.Random(prep.get("seed", 10))
    gc = collect_cases(Path(args.path_to_gc).resolve())
    sc = collect_cases(Path(args.path_to_sc).resolve())
    rng.shuffle(gc)
    rng.shuffle(sc)
    splits = {"train": sc, "val": gc[len(gc) // 2:],
              "test": gc[:len(gc) // 2]}

    out = (Path(args.out) if args.out else Path.cwd() / "dataset") \
        / prep["dataset_name"]
    PreProcessor(splits=splits, path_to_dataset="/", path_to_splits=out,
                 preprocessing_config=prep,
                 data_config={k: config[k] for k in DATA_KEYS}).run()
    return out


if __name__ == "__main__":
    main()
