"""Operations and bytes of the model's work, counted from the shapes the
config makes, whatever implements them.

- ``model_flops``: the model's own FLOPs at a batch, counted once by
  ``torch.utils.flop_counter.FlopCounterMode`` over the plain reference on
  the meta device: every conv as ``F.conv3d`` (so not the zero blocks of
  the port's packed band), the attention products and the linears, with
  the backward for training; no recomputation, no optimizer, no
  elementwise work.
- The kernel bounds: ``chip_smoke.py``'s arithmetic at transoar_tpu_torch
  commit bf64563 (``_bound``, ``_window_work``; the H100 SXM data sheet's
  dense bf16 peak and HBM rate at 700 W): the least time is the larger of
  the operations over the peak and the bytes over the memory rate, each
  input byte read once and each output byte written once. The band conv's
  work is the 3x3x3 conv's (``conv_work``), which the band computes with
  its zero blocks.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch

from benchmark.reference import geometry
from benchmark.reference import model as ref

PEAK_BF16_FLOPS, PEAK_BYTES_S = 989e12, 3.35e12


def bound_s(flops, nbytes):
    """The least seconds of ``flops`` and ``nbytes`` at the card's peaks."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S)


@functools.lru_cache(maxsize=None)
def _model_flops(cfg_json: str, batch: int, train: bool) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    cfg = json.loads(cfg_json)
    patch = tuple(cfg["augmentation"]["patch_size"])
    with torch.device("meta"):
        P = {n: torch.empty(s, requires_grad=train)
             for n, s in ref.param_shapes(cfg).items()}
        x = torch.empty((batch, *patch, 1))
    consts = {k: v.to("meta") for k, v in ref.constants(cfg, "cpu").items()}
    counter = FlopCounterMode(display=False)
    with counter, torch.set_grad_enabled(train):
        out = ref.forward(P, x, cfg, consts, train=False)
        if train:
            (out["pred_logits"].sum() + out["pred_boxes"].sum()
             + out["aux_logits"].sum() + out["aux_boxes"].sum()).backward()
    return int(counter.get_total_flops())


def model_flops(cfg, batch, train):
    """FLOPs of one forward (and backward with ``train``) at ``batch``."""
    return _model_flops(json.dumps(cfg, sort_keys=True), int(batch),
                        bool(train))


def conv_work(voxels, cin, cout, k=3):
    """(flops, bytes) of one bf16 k^3 conv over ``voxels`` output voxels:
    the input and the output read or written once, the kernel once."""
    flops = 2 * voxels * k ** 3 * cin * cout
    return flops, 2 * voxels * (cin + cout) + 2 * k ** 3 * cin * cout


def band_conv_bounds(cfg):
    """Bound seconds of the stage-0 chain's band-conv work at the cell's
    batch: {"fwd": both convs' forward, "dx": the second conv's input
    gradient, "dw": both convs' weight gradients}; None when the config
    takes no packed chain."""
    bb = cfg["backbone"]
    pack = int(bb.get("stage0_pack", 0))
    patch = tuple(cfg["augmentation"]["patch_size"])
    if not pack or tuple(bb["strides"][0]) != (1, 1, 1) or patch[0] % pack:
        return None
    voxels = int(cfg["trainer"]["batch_size"]) * int(np.prod(patch))
    c0, c = bb["in_channels"], bb["start_channels"]
    f1, b1 = conv_work(voxels, c0, c)
    f2, b2 = conv_work(voxels, c, c)
    # the weight gradient writes f32 kernels
    dw1 = b1 + 2 * 27 * c0 * c
    dw2 = b2 + 2 * 27 * c * c
    return {"fwd": bound_s(f1, b1) + bound_s(f2, b2),
            "dx": bound_s(f2, b2),
            "dw": bound_s(f1, dw1) + bound_s(f2, dw2)}


def window_work(B, H, N, d, nW, backward, itemsize=2):
    """(flops, bytes) of the forward (2 products) or the backward (5), each
    input read once and each output written once (``chip_smoke.py``)."""
    heads = B * H * N * d * itemsize
    consts = 4 * H * N * N + 4 * nW * N
    if backward:
        return 10 * B * H * N * N * d, 7 * heads + consts + 4 * H * N * N
    return 4 * B * H * N * N * d, 4 * heads + consts


def window_bounds(cfg):
    """Bound seconds of every Swin block's window attention at the cell's
    batch: {"fwd", "bwd", "blocks"}; None without Swin stages."""
    swin = cfg["backbone"].get("swin", {})
    batch = int(cfg["trainer"]["batch_size"])
    fwd = bwd = 0.0
    blocks = 0
    for s, (kind, dim, _, spatial, _) in enumerate(ref.stage_layout(cfg)):
        if kind != "swin":
            continue
        heads = swin["num_heads"][s - 2]
        for j in range(swin["depths"][s - 2]):
            shift = tuple(w // 2 for w in swin["window_size"]) if j % 2 \
                else (0, 0, 0)
            ws, ss = geometry.effective_window(spatial,
                                               swin["window_size"], shift)
            padded = [-(-n // w) * w for n, w in zip(spatial, ws)]
            nW = int(np.prod([p // w for p, w in zip(padded, ws)]))
            N = int(np.prod(ws))
            regions = nW if any(ss) else 1
            args = (batch * nW, heads, N, dim // heads, regions)
            fwd += bound_s(*window_work(*args, backward=False))
            bwd += bound_s(*window_work(*args, backward=True))
            blocks += 1
    return None if not blocks else {"fwd": fwd, "bwd": bwd, "blocks": blocks}
