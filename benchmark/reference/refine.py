"""Plain TransoarNet with the deformable refine of its FPN levels
(``use_decoder_attn``): the Deformable-DETR encoder (Zhu et al.,
arXiv:2010.04159), multi-scale deformable self-attention over every voxel
token of the ``def_attn.feature_levels`` (P3-P5 as shipped), in front of
the Focused Decoder. Written as functions of a flat parameter dict in
plain PyTorch, beside ``model.py``, whose encoder, FPN, Focused Decoder,
matcher, criterion and AdamW it takes by import.

The yardstick of the refine cell's ``correct``: frozen at
transoar_tpu_torch commit ace78ec from the math of
``models/{def_attn,attn_fpn}.py`` and ``ops/deformable_attention.py``
(TransOAR's ``models/backbones/decoder_blocks.py:12-177`` and
``models/ops``). What it adds to ``model.py``:

- the FPN's outputs at the refine's levels (``_out.{m}`` over the sorted
  union of ``out_fmaps`` and ``feature_levels``);
- the refine block's parameters, named as the port's ``state_dict``:
  ``_backbone._decoder._refine.level_embed`` [L, C] and
  ``..._refine.refine_def_attn.layers.{i}.{self_attn.{value_proj,
  sampling_offsets, attention_weights, output_proj}, norm1, linear1,
  linear2, norm2}``;
- the levels' tokens concatenated; the sine encoding of each level plus
  its level embedding; per-voxel reference points (the voxel centre,
  normalized, the same point at every level);
- ``layers`` post-norm layers: deformable self-attention, then the FFN;
  dropout after the attention, after the FFN's activation and after its
  second projection, drawn from the generator in the port's order and at
  its shapes;
- the sampling (``sample``), written from the reference CUDA op's
  definition and not from ``F.grid_sample``: a location ``loc`` in [0, 1]
  along an axis of n voxels lies at ``loc * n - 0.5``; its 8 corners are
  gathered explicitly, each weighted by the trilinear weights, zero where
  the corner lies outside the level; then the attention weights, and the
  sum over levels and points. Coordinate 0 of a location indexes the LAST
  spatial axis of a level, coordinate 2 the first. The queries run in
  blocks, each under ``torch.utils.checkpoint`` when a gradient is taken,
  so the full-size step fits beside nothing else on the card.

Precision: float32 throughout unless ``quant`` is given; then every tensor
the port holds in bf16 goes through it (the value, the softmaxed attention
weights, the query, the positions, the projections' operands and outputs,
the norms' outputs and the residual sums). The port keeps the sampling
offsets, the attention-weight logits and the sampling itself in f32, and
so are they left here.

Departures from the reference model: the valid ratios are all ones (no
padded volumes, as in the port); the op's value is sampled in f32 (the
reference CUDA op computes in the value's dtype); biases are not rounded
under ``quant`` (as ``model.py``). The seeded weights of the benchmark
replace the published init (zero offset and weight kernels, the
directional offset grid, N(0, 1) level embedding).

Nothing here imports the port.
"""

from __future__ import annotations

import copy
import itertools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import geometry
from benchmark.reference import model as base
# runs.train, pointed at this module, takes these from it
from benchmark.reference.model import AdamW, targets, total_loss  # noqa: F401

PREFIX = "_backbone._decoder._refine"
BLOCK = 4096  # queries a block of the sampling


def _ident(t):
    return t


def _base_config(cfg):
    """The config ``model.py`` reads: the refine off and its levels among
    the FPN's outputs."""
    bb = cfg["backbone"]
    if not bb.get("use_decoder_attn"):
        raise ValueError("the refine reference needs use_decoder_attn")
    out = copy.deepcopy(cfg)
    out["backbone"]["out_fmaps"] = sorted(
        set(bb["out_fmaps"]) | set(bb["def_attn"]["feature_levels"]))
    out["backbone"]["use_decoder_attn"] = False
    return out


def level_shapes(cfg) -> list:
    """[(s0, s1, s2)] of each refined level, in ``feature_levels`` order."""
    layout = base.stage_layout(cfg)
    out = []
    for level in cfg["backbone"]["def_attn"]["feature_levels"]:
        _, _, _, spatial, stride = layout[int(level[1:])]
        out.append(tuple(-(-a // b) for a, b in zip(spatial, stride)))
    return out


def param_shapes(cfg) -> dict:
    """{name: shape} of every parameter, as the port's ``state_dict``."""
    shapes = base.param_shapes(_base_config(cfg))
    da = cfg["backbone"]["def_attn"]
    C, ff, M = da["hidden_dim"], da["dim_feedforward"], da["nheads"]
    LP = len(da["feature_levels"]) * da["n_points"]
    shapes[f"{PREFIX}.level_embed"] = (len(da["feature_levels"]), C)
    for i in range(da["layers"]):
        p = f"{PREFIX}.refine_def_attn.layers.{i}"
        for name, (rows, cols) in (
                ("self_attn.value_proj", (C, C)),
                ("self_attn.sampling_offsets", (M * LP * 3, C)),
                ("self_attn.attention_weights", (M * LP, C)),
                ("self_attn.output_proj", (C, C)),
                ("linear1", (ff, C)), ("linear2", (C, ff))):
            shapes[f"{p}.{name}.weight"] = (rows, cols)
            shapes[f"{p}.{name}.bias"] = (rows,)
        for name in ("norm1", "norm2"):
            shapes[f"{p}.{name}.weight"] = (C,)
            shapes[f"{p}.{name}.bias"] = (C,)
    return shapes


def reference_points(shapes) -> np.ndarray:
    """[S, 3]: each token's voxel centre, normalized, coordinate 0 along
    the last axis, the levels' tokens concatenated."""
    pts = []
    for s0, s1, s2 in shapes:
        g0, g1, g2 = np.meshgrid((np.arange(s0) + 0.5) / s0,
                                 (np.arange(s1) + 0.5) / s1,
                                 (np.arange(s2) + 0.5) / s2, indexing="ij")
        pts.append(np.stack([g2, g1, g0], -1).reshape(-1, 3))
    return np.concatenate(pts, 0)


def constants(cfg, device):
    """``model.constants`` plus the refine's: the levels' sine tables
    [S, C], each token's level [S] and reference point [S, 3]."""
    out = base.constants(cfg, device)
    shapes = level_shapes(cfg)
    C = cfg["backbone"]["def_attn"]["hidden_dim"]
    sine = np.concatenate([geometry.sine_position_encoding(s, C)
                           .reshape(-1, C) for s in shapes])
    level = np.repeat(np.arange(len(shapes)), [int(np.prod(s))
                                               for s in shapes])
    out["refine_sine"] = torch.as_tensor(sine, dtype=torch.float32,
                                         device=device)
    out["refine_level"] = torch.as_tensor(level, device=device)
    out["refine_ref"] = torch.as_tensor(reference_points(shapes),
                                        dtype=torch.float32, device=device)
    return out


# ---------------------------------------------------------------------------
# the sampling
# ---------------------------------------------------------------------------

def _sample_block(rows, loc, weights, shapes, S):
    """One block of queries: rows [B * M * S, D] (the value, row (b, m,
    s)), loc [B, Qb, M, L, P, 3], weights [B, Qb, M, L, P] -> [B, Qb, M,
    D]."""
    B, Qb, M = loc.shape[:3]
    dev = loc.device
    head_row = ((torch.arange(B, device=dev)[:, None] * M
                 + torch.arange(M, device=dev)) * S)[:, None, :, None]
    out, start = 0.0, 0
    for lvl, dims in enumerate(shapes):
        size = torch.tensor(dims, device=dev)
        # voxel position along axes 0, 1, 2: coordinate 2 - a indexes a
        pos = loc[:, :, :, lvl].flip(-1) * size - 0.5  # [B, Qb, M, P, 3]
        lo = pos.floor()
        frac = pos - lo
        lo = lo.long()
        for corner in itertools.product((0, 1), repeat=3):
            c = torch.tensor(corner, device=dev)
            idx = lo + c
            inside = ((idx >= 0) & (idx < size)).all(-1)
            trilinear = torch.where(c == 1, frac, 1.0 - frac).prod(-1)
            idx = torch.minimum(idx.clamp_min(0), size - 1)
            flat = (idx[..., 0] * dims[1] + idx[..., 1]) * dims[2] \
                + idx[..., 2] + start
            w = torch.where(inside, trilinear, 0.0) * weights[:, :, :, lvl]
            out = out + (rows[head_row + flat] * w[..., None]).sum(3)
        start += int(np.prod(dims))
    return out


def sample(value, shapes, loc, weights, block=BLOCK):
    """Multi-scale deformable sampling: value [B, S, M, D] (the levels'
    tokens concatenated in ``shapes`` order), loc [B, Q, M, L, P, 3]
    (normalized, coordinate 0 = the last axis), weights [B, Q, M, L, P]
    -> [B, Q, M * D] f32."""
    B, S, M, D = value.shape
    rows = value.float().permute(0, 2, 1, 3).reshape(B * M * S, D)
    loc, weights = loc.float(), weights.float()
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (rows, loc, weights))
    outs = []
    for q0 in range(0, loc.shape[1], block):
        args = (rows, loc[:, q0:q0 + block], weights[:, q0:q0 + block],
                shapes, S)
        outs.append(checkpoint(_sample_block, *args, use_reentrant=False)
                    if grad else _sample_block(*args))
    return torch.cat(outs, 1).flatten(2)


# ---------------------------------------------------------------------------
# the refine block
# ---------------------------------------------------------------------------

def _deformable_attention(query, src, P, p, shapes, ref, da, q):
    """query, src [B, S, C] -> [B, S, C]: every token a query over every
    level's tokens."""
    B, Q, C = query.shape
    M, L, Pn = da["nheads"], len(shapes), da["n_points"]
    value = base._linear(src, P[f"{p}.value_proj.weight"],
                         P[f"{p}.value_proj.bias"], q).view(B, -1, M, C // M)
    offsets = F.linear(query, P[f"{p}.sampling_offsets.weight"],
                       P[f"{p}.sampling_offsets.bias"]).view(B, Q, M, L, Pn,
                                                             3)
    logits = F.linear(query, P[f"{p}.attention_weights.weight"],
                      P[f"{p}.attention_weights.bias"]).view(B, Q, M, L * Pn)
    weights = q(logits.softmax(-1)).view(B, Q, M, L, Pn)
    normalizer = torch.tensor([[s2, s1, s0] for s0, s1, s2 in shapes],
                              dtype=torch.float32, device=query.device)
    loc = ref[None, :, None, None, None, :] \
        + offsets / normalizer[:, None, :]
    out = sample(value, shapes, loc, weights)
    return base._linear(out, P[f"{p}.output_proj.weight"],
                        P[f"{p}.output_proj.bias"], q)


def refine(fmaps, P, cfg, consts, gen=None, train=False, q=_ident):
    """fmaps: the refined levels [B, s0, s1, s2, C] -> the refined list."""
    da = cfg["backbone"]["def_attn"]
    B, C = fmaps[0].shape[0], fmaps[0].shape[-1]
    shapes = [tuple(f.shape[1:4]) for f in fmaps]
    src = torch.cat([f.reshape(B, -1, C) for f in fmaps], 1)
    embed = P[f"{PREFIX}.level_embed"][consts["refine_level"]]
    pos = q(q(consts["refine_sine"]) + q(embed))[None]
    drop = float(da["dropout"]) if train else 0.0
    for i in range(da["layers"]):
        p = f"{PREFIX}.refine_def_attn.layers.{i}"
        attn = _deformable_attention(q(src + pos), src, P, f"{p}.self_attn",
                                     shapes, consts["refine_ref"], da, q)
        src = base._layer_norm(q(src + base._dropout(attn, drop, gen)), P,
                               f"{p}.norm1", q)
        h = base._dropout(F.relu(base._linear(src, P[f"{p}.linear1.weight"],
                                              P[f"{p}.linear1.bias"], q)),
                          drop, gen)
        h = base._linear(h, P[f"{p}.linear2.weight"], P[f"{p}.linear2.bias"],
                         q)
        src = base._layer_norm(q(src + base._dropout(h, drop, gen)), P,
                               f"{p}.norm2", q)
    sizes = [int(np.prod(s)) for s in shapes]
    return [t.reshape(B, *s, C) for t, s in zip(src.split(sizes, 1), shapes)]


def forward(P, x, cfg, consts, gen=None, train=False, q=_ident):
    """x [B, S0, S1, S2, 1] -> {pred_logits [B, Q, 1], pred_boxes [B, Q, 6],
    aux_logits, aux_boxes [L-1, B, Q, .]}, as ``model.forward`` with the
    refined levels in place of their P-levels."""
    bcfg = _base_config(cfg)
    feats = base.fpn(base.encoder(x, P, bcfg, gen, train, q), P, bcfg, q)
    levels = [int(lv[1:]) for lv in cfg["backbone"]["def_attn"][
        "feature_levels"]]
    feats.update(zip(levels, refine([feats[s] for s in levels], P, cfg,
                                    consts, gen, train, q)))
    level = int(cfg["neck"]["input_levels"][-1])
    hs = base.neck_forward(feats[level], P, cfg, consts, gen, train, q)
    logits = base._linear(hs, P["_cls_head.weight"], P["_cls_head.bias"], q)
    raw = hs
    for i in range(3):
        raw = base._linear(raw, P[f"_reg_head.layers.{i}.weight"],
                           P[f"_reg_head.layers.{i}.bias"], q)
        if i < 2:
            raw = F.relu(raw)
    boxes = (torch.tanh(raw) * consts["restrictions"]
             + consts["anchors"]).clamp(0.0, 1.0)
    out = {"pred_logits": logits[-1], "pred_boxes": boxes[-1]}
    if cfg["neck"].get("aux_loss"):
        out["aux_logits"], out["aux_boxes"] = logits[:-1], boxes[:-1]
    return out
