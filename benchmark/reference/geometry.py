"""Static geometry of the model, worked out from the config: Swin window
clamping, partition and the shifted-window regions, the relative-position
index, the anchors and their restrictions, the per-organ attention bias and
the sine position table.

Frozen copies, at transoar_tpu_torch commit bf64563, of
``models/swin.py`` (``effective_window``, ``window_partition``,
``window_reverse``, ``relative_position_index``,
``shifted_window_regions``), ``models/anchors.py`` (``generate_anchors``),
``models/focused_decoder.py`` (``generate_attn_bias``) and
``models/position_encoding.py`` (``sine_position_encoding``). A later change
of the port's geometry shows as a failed ``correct``, not as a moved
yardstick.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

MASKED_BIAS = -1e9


def effective_window(spatial, window_size, shift_size):
    """Clamp window to the volume size; no shift along collapsed axes
    (reference get_window_size, encoder_blocks.py:371-384)."""
    ws, ss = list(window_size), list(shift_size)
    for i, s in enumerate(spatial):
        if s <= window_size[i]:
            ws[i] = s
            ss[i] = 0
    return tuple(ws), tuple(ss)


def window_partition(x, ws):
    """[B, D, H, W, C] -> [B*nW, ws0*ws1*ws2, C]
    (encoder_blocks.py:360-364)."""
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2], ws[2],
                  C)
    x = x.transpose(0, 1, 3, 5, 2, 4, 6, 7) if isinstance(x, np.ndarray) \
        else x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, ws[0] * ws[1] * ws[2], C)


def window_reverse(windows, ws, B, D, H, W):
    x = windows.reshape(B, D // ws[0], H // ws[1], W // ws[2], ws[0], ws[1],
                        ws[2], -1)
    x = x.transpose(0, 1, 4, 2, 5, 3, 6, 7) if isinstance(x, np.ndarray) \
        else x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, -1)


def relative_position_index(ws) -> np.ndarray:
    """[N, N] indices into the (2w0-1)(2w1-1)(2w2-1) bias table
    (encoder_blocks.py:234-248)."""
    coords = np.stack(np.meshgrid(np.arange(ws[0]), np.arange(ws[1]),
                                  np.arange(ws[2]), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [3, N, N]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws[0] - 1
    rel[:, :, 1] += ws[1] - 1
    rel[:, :, 2] += ws[2] - 1
    rel[:, :, 0] *= (2 * ws[1] - 1) * (2 * ws[2] - 1)
    rel[:, :, 1] *= 2 * ws[2] - 1
    return rel.sum(-1)


def shifted_window_regions(padded_shape, ws, ss) -> np.ndarray:
    """[nW, N] per-token region labels of the cyclic shift: two tokens may
    attend iff their labels match (encoder_blocks.py:387-400)."""
    Dp, Hp, Wp = padded_shape

    def axis_regions(ws_i, ss_i):
        # a zero-shift axis is ONE region spanning everything
        if ss_i == 0:
            return (slice(None),)
        return (slice(-ws_i), slice(-ws_i, -ss_i), slice(-ss_i, None))

    img = np.zeros((1, Dp, Hp, Wp, 1), np.float32)
    cnt = 0
    for d in axis_regions(ws[0], ss[0]):
        for h in axis_regions(ws[1], ss[1]):
            for w in axis_regions(ws[2], ss[2]):
                img[:, d, h, w, :] = cnt
                cnt += 1
    return window_partition(img, ws)[..., 0].astype(np.float32)


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


def generate_attn_bias(bbox_props, input_shape, restrict=True):
    """Per-organ additive attention bias over the flattened token axis
    (reference ``generate_attn_masks``, focused_decoder.py:138-159).

    Returns float32 ``[num_organs, S0*S1*S2]`` with 0 inside the organ's
    ``attn_area`` (scaled to the grid, floored/ceiled) and ``MASKED_BIAS``
    outside (all-zero if ``restrict`` is False).
    """
    shape = np.asarray(input_shape, np.float64)
    cls_ids = sorted(bbox_props.keys(), key=lambda k: int(k))
    num_organs = len(cls_ids)

    bias = np.zeros((num_organs, *input_shape), np.float32)
    if restrict:
        bias[:] = MASKED_BIAS
        for i, cls in enumerate(cls_ids):
            area = np.asarray(bbox_props[cls]["attn_area"], np.float64)
            vox = area * np.concatenate([shape, shape])
            vox = np.clip(vox, 0, np.concatenate([shape, shape]))
            lo = np.floor(vox[:3]).astype(int)
            hi = np.ceil(vox[3:]).astype(int)
            bias[i, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 0.0
    return bias.reshape(num_organs, -1)


def sine_position_encoding(spatial_shape, channels, temperature=10000.0,
                           scale=2 * math.pi) -> np.ndarray:
    """The [S0, S1, S2, C] sine table (float64) for a static spatial shape."""
    per_axis = int(np.ceil(channels / 6) * 2)

    dim_t = np.arange(per_axis, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / per_axis)

    def axis_embed(size):
        grid = (np.arange(size, dtype=np.float64) + 0.5) / size * scale
        pos = grid[:, None] / dim_t[None, :]
        return np.concatenate([np.sin(pos[:, 0::2]), np.cos(pos[:, 1::2])],
                              axis=-1)

    s0, s1, s2 = spatial_shape
    pos_x = axis_embed(s0)[:, None, None, :]  # varies along axis 0
    pos_y = axis_embed(s1)[None, :, None, :]  # varies along axis 1
    pos_z = axis_embed(s2)[None, None, :, :]  # varies along axis 2
    zeros = np.zeros((s0, s1, s2, per_axis))
    pos = np.concatenate([pos_y + zeros, pos_x + zeros, pos_z + zeros],
                         axis=-1)
    return pos[..., :channels]
