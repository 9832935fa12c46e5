"""AMOS dataset preparation (twin of ``scripts/prepare_dataset_amos.py``):

    python -m transoar_tpu_torch.prepare_dataset_amos \
        --path_to_dataset <raw AMOS dir> [--config dataset_amos] [--out D]

Expects the AMOS layout (``imagesTr/`` and ``labelsTr/`` with one NIfTI
file per case, the same name in both). Splits the cases by a seeded
shuffle into the train / val / test counts of the dataset config
(reference prepare_dataset_amos.py:31-37), then runs the ``PreProcessor``
into ``<out or ./dataset>/<preprocessing.dataset_name>/``. Host only.
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

from transoar_tpu_torch.data.preprocessor import PreProcessor
from transoar_tpu_torch.utils.io import get_config, set_root_logger

DATA_KEYS = ("num_classes", "labels", "labels_small", "labels_mid",
             "labels_large")


def collect_cases(root: Path):
    cases = []
    for img in sorted((root / "imagesTr").glob("*.nii*")):
        lbl = root / "labelsTr" / img.name
        if lbl.exists():
            cases.append({"image": str(img.relative_to(root)),
                          "label": str(lbl.relative_to(root)),
                          "name": img.name.split(".")[0]})
    return cases


def main(argv=None):
    """Prepare the dataset; returns the output directory."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--path_to_dataset", required=True)
    parser.add_argument("--config", default="dataset_amos",
                        help="Dataset config in ./config, or a .yaml path.")
    parser.add_argument("--out", default=None,
                        help="Output root (default ./dataset).")
    args = parser.parse_args(argv)

    set_root_logger(Path.cwd() / "logs" / "prepare_dataset.log")
    config = get_config(args.config)
    prep = config["preprocessing"]

    cases = collect_cases(Path(args.path_to_dataset))
    random.Random(prep.get("seed", 10)).shuffle(cases)
    n_train, n_val, n_test = prep["num_train"], prep["num_val"], \
        prep["num_test"]
    splits = {"train": cases[:n_train],
              "val": cases[n_train:n_train + n_val],
              "test": cases[n_train + n_val:n_train + n_val + n_test]}

    out = (Path(args.out) if args.out else Path.cwd() / "dataset") \
        / prep["dataset_name"]
    PreProcessor(splits=splits, path_to_dataset=args.path_to_dataset,
                 path_to_splits=out, preprocessing_config=prep,
                 data_config={k: config[k] for k in DATA_KEYS}).run()
    return out


if __name__ == "__main__":
    main()
