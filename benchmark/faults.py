"""Faults planted in the port underneath a run, to show that the check
catches them (the tests) and to read them at a cell's size (calibration):

- ``state_unchanged``: the train step skips its update
  (``train_state.UpdateRule.__call__`` does nothing);
- ``half_batch``: the train step leaves out half of its batch and takes
  the mean over the rest (``trainer._prepare`` keeps the first half);
- ``altered_answer``: the served scores are altered where they are made
  (``predict.inference`` scales them by 0.9).

A one-card cell has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import importlib


def _state_unchanged(module):
    return module.UpdateRule, "__call__", lambda self: False


def _half_batch(module):
    prepare = module._prepare

    def half(batch, stats):
        image, seg = prepare(batch, stats)
        n = image.shape[0] // 2
        return image[:n], seg[:n]

    return module, "_prepare", half


def _altered_answer(module):
    decode = module.inference

    def altered(out, organs):
        boxes, classes, scores = decode(out, organs)
        return boxes, classes, [s * 0.9 for s in scores]

    return module, "inference", altered


FAULTS = {
    "state_unchanged": ("transoar_tpu_torch.training.train_state",
                        _state_unchanged),
    "half_batch": ("transoar_tpu_torch.training.trainer", _half_batch),
    "altered_answer": ("transoar_tpu_torch.predict", _altered_answer),
}


@contextlib.contextmanager
def planted(name: str):
    """The port with fault ``name`` in place, restored on exit."""
    module_name, make = FAULTS[name]
    owner, attr, replacement = make(importlib.import_module(module_name))
    saved = getattr(owner, attr)
    setattr(owner, attr, replacement)
    try:
        yield
    finally:
        setattr(owner, attr, saved)
