"""Prediction decoding: model outputs -> one box, class and score per organ.

Copy of the numpy ``inference`` in ``transoar_tpu/training/inference.py``
(that module imports jax). Sigmoid the logits, group the queries per organ
and keep each organ's best query; the whole batch is decoded (the reference
``return`` inside its batch loop emitted only element 0).
"""

from __future__ import annotations

import numpy as np


def inference(out, num_organs):
    """Returns per-image lists (boxes [organs, 6], classes [organs],
    scores [organs]), classes 1-based. ``out`` holds numpy arrays.

    One binary logit per query = focused branch (queries own their class
    positionally); softmax over ``num_organs + 1`` classes = DETR branches
    (best query per class over the whole query set).
    """
    logits = np.asarray(out["pred_logits"])
    boxes = np.asarray(out["pred_boxes"])
    B = logits.shape[0]

    if logits.shape[-1] == 1:
        probs = 1.0 / (1.0 + np.exp(-logits[..., 0]))
        Q = probs.shape[1]
        qpo = Q // num_organs
        probs = probs.reshape(B, num_organs, qpo)
        boxes = boxes.reshape(B, num_organs, qpo, 6)

        best = probs.argmax(-1)  # [B, organs]
        b_idx = np.arange(B)[:, None]
        o_idx = np.arange(num_organs)[None, :]
        sel_boxes = boxes[b_idx, o_idx, best]
        sel_scores = probs[b_idx, o_idx, best]
    else:
        e = np.exp(logits - logits.max(-1, keepdims=True))
        probs = (e / e.sum(-1, keepdims=True))[..., 1:]  # drop no-object
        best = probs.argmax(axis=1)       # [B, organs] best query per class
        sel_scores = probs.max(axis=1)    # [B, organs]
        b_idx = np.arange(B)[:, None]
        sel_boxes = boxes[b_idx, best]    # [B, organs, 6]

    classes = np.tile(np.arange(1, num_organs + 1), (B, 1))
    return (list(sel_boxes), list(classes), list(sel_scores))
