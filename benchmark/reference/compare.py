"""The comparisons that decide ``correct``: each reading is a gap of the
program (or of the control put in its place) from the plain reference,
held against the cell's limit in ``benchmark/limits/<cell>.json``.

Training (the first three steps of the object the window drives):

- ``loss_cls.step<k>``: |L_program - L_reference| / |L_reference| of step
  k's classification loss (final and auxiliary layers, weighted). It
  stands for the total loss, which differs from seed to seed by the
  matcher alone: with ``cost_class`` the only cost, each organ's box loss
  goes to the query of highest logit, and at random weights two of its 27
  queries often lie closer than bf16's rounding, so the two sides pick
  different queries on some seeds. The classification part is BCE
  against soft labels the anchors fix, whichever query is picked;
- ``grad1.worst_leaf``: the first gradient as the optimizer got it (AdamW's
  first moment after one step over 1 - beta1), per leaf the gap of its norm
  from the reference's, over the reference's norm of that leaf or of the
  median leaf, whichever is larger; the worst leaf;
- ``change3.worst_leaf``: the same of the parameters' change after three
  steps, over the elements whose reference gradient at step 1 is at least
  a thousandth of the median leaf's RMS gradient
  (``runs.moving_elements``: the others, such as the key's third of the
  packed attention bias under softmax, get round-off gradients that Adam
  turns into full steps).

Serving (the sampled requests, per organ at the query the program's own
outputs rank first):

- ``pick.gap``: how far the reference's probability of that query lies
  below the reference's best query of the organ;
- ``score.gap``: |served score - the reference's probability of it|;
- ``box.gap``: the largest gap of the served box's normalized coordinates
  from the reference's box of that query;
- ``world_mm.gap``: the largest gap of the served world corners (mm) from
  the reference's.
"""

from __future__ import annotations

import statistics

import numpy as np


def _leaf_gaps(prog: dict, ref: dict) -> dict:
    """Per leaf, the gap of the program's norm from the reference's over
    the reference's norm of that leaf or of the median leaf."""
    med = statistics.median(ref.values())
    return {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
            for n in ref}


def _worst_leaf(prog: dict, ref: dict):
    gaps = _leaf_gaps(prog, ref)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def train_readings(prog: dict, ref: dict) -> tuple[dict, dict]:
    """({check name: reading}, {check name: worst leaf}) of ``prog``
    against ``ref``; both hold ``loss_cls`` [steps], ``grad1`` and
    ``change`` {leaf: norm}."""
    out, where = {}, {}
    for k, (lp, lr) in enumerate(zip(prog["loss_cls"], ref["loss_cls"]),
                                 1):
        out[f"loss_cls.step{k}"] = abs(lp - lr) / max(abs(lr), 1e-30)
    out["grad1.worst_leaf"], where["grad1.worst_leaf"] = _worst_leaf(
        prog["grad1"], ref["grad1"])
    out["change3.worst_leaf"], where["change3.worst_leaf"] = _worst_leaf(
        prog["change"], ref["change"])
    return out, where


def serve_readings(prog: list, ref: list) -> dict:
    """``prog``: per sampled request {"pick" [O] (query index), "scores"
    [O], "boxes" [O, 6], "world" [O, 6]}; ``ref``: per request {"probs"
    [O, qpo], "boxes" [O, qpo, 6], "world" [O, qpo, 6]}."""
    pick = score = box = world = 0.0
    for p, r in zip(prog, ref):
        o = np.arange(len(p["pick"]))
        at = r["probs"][o, p["pick"]]
        pick = max(pick, float((r["probs"].max(-1) - at).max()))
        score = max(score, float(np.abs(p["scores"] - at).max()))
        box = max(box, float(np.abs(p["boxes"] - r["boxes"][o, p["pick"]])
                             .max()))
        world = max(world, float(np.abs(p["world"]
                                        - r["world"][o, p["pick"]]).max()))
    return {"pick.gap": pick, "score.gap": score, "box.gap": box,
            "world_mm.gap": world}
