"""Operations and bytes of the refine cell's work, counted from the shapes
the config makes, whatever implements them (``work.py``'s rules, for the
plain reference with the deformable refine, ``refine.py``):

- ``model_flops``: the model's own FLOPs at a batch, counted once by
  ``torch.utils.flop_counter.FlopCounterMode`` over ``refine.forward`` on
  the meta device, with the backward for training: ``work.model_flops``'s
  convs, attention products and linears plus the refine's linears (value,
  offsets, attention weights, output, FFN). The sampling is gathers and
  elementwise work, which the counter does not count.
- ``sampling_bounds``: the least time of one call of the deformable
  sampling, forward and backward, at the cell's shapes (``work.bound_s``:
  the larger of the operations over the bf16 peak and the bytes over the
  memory rate). Bytes at the op's interface, each input read once and each
  output written once: the value [B, S, M, D] and the attention weights [B,
  Q, M, L, P] in the compute dtype, the locations [B, Q, M, L, P, 3] and
  the output [B, Q, M * D] in f32; the backward reads the output's
  gradient and the three inputs and writes their gradients. Operations:
  per sample and channel, 8 corner products and the weighted sum, two
  operations each (the forward), twice that for the backward.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch

from benchmark.reference import refine
from benchmark.reference.work import bound_s


@functools.lru_cache(maxsize=None)
def _model_flops(cfg_json: str, batch: int, train: bool) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    cfg = json.loads(cfg_json)
    patch = tuple(cfg["augmentation"]["patch_size"])
    with torch.device("meta"):
        P = {n: torch.empty(s, requires_grad=train)
             for n, s in refine.param_shapes(cfg).items()}
        x = torch.empty((batch, *patch, 1))
    consts = {k: v.to("meta")
              for k, v in refine.constants(cfg, "cpu").items()}
    counter = FlopCounterMode(display=False)
    with counter, torch.set_grad_enabled(train):
        out = refine.forward(P, x, cfg, consts, train=False)
        if train:
            (out["pred_logits"].sum() + out["pred_boxes"].sum()
             + out["aux_logits"].sum() + out["aux_boxes"].sum()).backward()
    return int(counter.get_total_flops())


def model_flops(cfg, batch, train):
    """FLOPs of one forward (and backward with ``train``) at ``batch``."""
    return _model_flops(json.dumps(cfg, sort_keys=True), int(batch),
                        bool(train))


def sampling_bounds(cfg):
    """{"fwd", "bwd": bound seconds of one call at the cell's batch,
    "samples": its sampled points B * Q * M * L * P}."""
    da = cfg["backbone"]["def_attn"]
    B = int(cfg["trainer"]["batch_size"])
    S = sum(int(np.prod(s)) for s in refine.level_shapes(cfg))
    M, C = da["nheads"], da["hidden_dim"]
    samples = B * S * M * len(da["feature_levels"]) * da["n_points"]
    item = 2 if cfg["trainer"].get("precision") == "bfloat16" else 4
    value, weights = B * S * C * item, samples * item
    loc, out = samples * 3 * 4, B * S * C * 4
    flops = 2 * (8 + 1) * (C // M) * samples
    return {"fwd": bound_s(flops, value + weights + loc + out),
            "bwd": bound_s(2 * flops, out + 2 * (value + weights + loc)),
            "samples": samples}
