"""Anchors from dataset box statistics (copy of ``generate_anchors`` and
``synthetic_bbox_props`` from ``transoar_tpu/models/anchors.py``; the tests
pin both to the originals).

Per organ: the anchor center is the center of its ``attn_area``, the size
its median box size, with ``num_queries / num_organs`` anchors at cartesian
position offsets; the restrictions bound the predicted tanh offsets.
Classes run in ascending id, so anchor slot ``i`` belongs to organ
``i + 1``.
"""

from __future__ import annotations

import itertools

import numpy as np


def _cartesian_offsets(per_axis_offsets):
    """All combinations taking one offset per axis -> [27, 3]."""
    cols = [per_axis_offsets[:, a] for a in range(3)]
    return np.array(list(itertools.product(*cols)), dtype=np.float64)


def generate_anchors(neck_config, bbox_props):
    """Returns (anchors [Q, 6] cxcyczwhd in [0, 1], restrictions [Q, 6]),
    the position restrictions already halved."""
    num_queries = neck_config["num_queries"]
    num_organs = neck_config["num_organs"]
    qpo = num_queries // num_organs
    dynamic = neck_config["anchor_gen_dynamic_offset"]

    cls_ids = sorted(bbox_props.keys(), key=lambda k: int(k))
    if len(cls_ids) != num_organs:
        raise ValueError(
            f"bbox_properties has {len(cls_ids)} classes, config expects "
            f"{num_organs} organs")

    anchors, restr_pos, medians, mins, maxs = [], [], [], [], []
    for cls in cls_ids:
        props = bbox_props[cls]
        median_size = np.asarray(props["median"], np.float64)[3:]
        attn = np.asarray(props["attn_area"], np.float64)
        center = (attn[:3] + attn[3:]) / 2
        attn_whd = attn[3:] - attn[:3]

        if dynamic:
            base = (attn_whd - median_size) / 3
            per_axis = np.stack([base, -base, np.zeros(3)])
        else:
            off = neck_config["anchor_gen_offset"]
            per_axis = np.array([[0.0] * 3, [off] * 3, [-off] * 3])

        if qpo == 1:
            offsets = np.zeros((1, 3))
        elif qpo == 7:
            # (+x, -x, +y, -y, +z, -z, 0), zero offset last
            offsets = np.zeros((7, 3))
            for axis in range(3):
                offsets[2 * axis, axis] = per_axis[0, axis]
                offsets[1 + 2 * axis, axis] = per_axis[1, axis]
        else:
            offsets = _cartesian_offsets(per_axis)

        if offsets.shape[0] != qpo:
            raise ValueError(
                f"organ {cls}: generated {offsets.shape[0]} offsets for "
                f"{qpo} queries/organ")

        cls_anchors = np.concatenate(
            [offsets + center, np.tile(median_size, (qpo, 1))], axis=-1)
        anchors.append(cls_anchors)
        restr_pos.append(offsets.max(axis=0))

        medians.append(median_size)
        mins.append(np.asarray(props["min"], np.float64)[3:])
        maxs.append(np.asarray(props["max"], np.float64)[3:])

    anchors = np.clip(np.concatenate(anchors), 0.0, 1.0)

    medians, mins, maxs = map(np.stack, (medians, mins, maxs))
    size_restr = np.maximum(medians - mins, maxs - medians)
    restr = np.concatenate([np.stack(restr_pos), size_restr], axis=-1)
    restr = np.repeat(restr, qpo, axis=0)
    restr[:, :3] /= 2

    return anchors.astype(np.float32), restr.astype(np.float32)


def synthetic_bbox_props(num_organs, seed=0, volume_frac=0.08):
    """Plausible ``bbox_properties`` for runs without real data: organs on
    jittered centers with attention areas that contain their boxes."""
    rng = np.random.default_rng(seed)
    props = {}
    for i in range(num_organs):
        center = rng.uniform(0.25, 0.75, 3)
        size = rng.uniform(0.08, 0.25, 3) * (1 + volume_frac)
        spread = rng.uniform(0.02, 0.08, 3)
        lo = np.clip(center - size / 2 - spread, 0, 1)
        hi = np.clip(center + size / 2 + spread, 0, 1)
        median = np.concatenate([center, size])
        props[str(i + 1)] = {
            "median": median.tolist(),
            "mean": median.tolist(),
            "min": np.concatenate([center, size * 0.8]).tolist(),
            "max": np.concatenate([center, size * 1.25]).tolist(),
            "percentile_99_5": np.concatenate([center, size * 1.2]).tolist(),
            "percentile_00_5": np.concatenate([center, size * 0.85]).tolist(),
            "attn_area": np.concatenate([lo, hi]).tolist(),
        }
    return props
