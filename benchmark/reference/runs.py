"""The plain reference run over a check's inputs, in blocks that fit
beside nothing else on the card: the first training steps, or the sampled
served requests from their NIfTI files. ``quant`` (the control) rounds the
products' operands as ``reference.quant.fp8`` does."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import model as ref
from benchmark.reference import nifti


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def train(cfg, weights, batches, gen_seed, device, quant=None,
          moving=None) -> dict:
    """{"loss": [each step's total loss], "loss_cls": [its
    classification part], "grad1": {leaf: norm of step 1's
    gradient}, "moving": {leaf: bool mask of the elements whose step-1
    gradient is at least a thousandth of the median leaf's RMS gradient},
    "change": {leaf: norm of the moving elements' change after the steps}}
    of ``len(batches)`` reference steps from ``weights``, dropout drawn
    from a generator seeded ``gen_seed``; ``moving`` (the f32 reference's,
    for the control) replaces the mask."""
    q = quant or (lambda t: t)
    P = {n: w.detach().clone().requires_grad_() for n, w in weights.items()}
    names = list(P)
    opt = ref.AdamW(P, cfg)
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    consts = ref.constants(cfg, device)
    organs = cfg["neck"]["num_organs"]
    out = {"loss": [], "loss_cls": []}
    with exact_f32():
        for i, batch in enumerate(batches):
            boxes, present = ref.targets(batch["seg"].long(), organs,
                                         cfg.get("bbox_padding", 1))
            pred = ref.forward(P, batch["image"].float(), cfg, consts, gen,
                               train=True, q=q)
            loss, loss_cls = ref.total_loss(pred, boxes, present, consts,
                                            cfg)
            grads = torch.autograd.grad(loss, [P[n] for n in names],
                                        allow_unused=True)
            del pred
            out["loss"].append(float(loss.detach()))
            out["loss_cls"].append(float(loss_cls))
            grads = {n: g for n, g in zip(names, grads) if g is not None}
            if i == 0:
                out["grad1"] = {n: float(grads[n].norm()) if n in grads
                                else 0.0 for n in names}
                out["moving"] = moving or moving_elements(grads, names)
            opt.step(grads)
            del grads, loss
    out["change"] = masked_norms({n: P[n].detach() - weights[n]
                                  for n in names}, out["moving"])
    return out


def moving_elements(grads: dict, names) -> dict:
    """Per leaf, the elements whose gradient is at least a thousandth of the
    median leaf's RMS gradient: the others (a key's bias under softmax) get
    a gradient that is round-off, which Adam turns into full steps."""
    rms = sorted(float(g.norm()) / g.numel() ** 0.5 for g in grads.values())
    floor = 1e-3 * rms[len(rms) // 2]
    return {n: (grads[n].abs() >= floor) if n in grads else None
            for n in names}


def masked_norms(deltas: dict, masks: dict) -> dict:
    """{leaf: norm of the masked elements of its delta} (0 without a
    mask)."""
    return {n: float(d[masks[n]].norm()) if masks.get(n) is not None
            else 0.0 for n, d in deltas.items()}


def prepare(path, target, stats, device):
    """NIfTI file -> the model input [1, S0, S1, S2, 1] (f32 on ``device``),
    the RAS shape and affine: decode, reorient to RAS, resize (linear, the
    pixel-edge grid, edges extended) and the intensity window."""
    img = nifti.load_nifti(path)
    ras, affine = nifti.reorient_ras(img["data"], img["affine"])
    x = torch.as_tensor(np.ascontiguousarray(ras, np.float32), device=device)
    x = F.interpolate(x[None, None].double(), size=tuple(target),
                      mode="trilinear", align_corners=False).float()[0, 0]
    if stats is not None:
        lo, hi = stats["percentile_00_5"], stats["percentile_99_5"]
        x = ((x - lo) / (hi - lo)).clamp(0.0, 1.0)
    return x[None, ..., None], ras.shape, affine


@torch.no_grad()
def serve(cfg, weights, paths, device, quant=None) -> list:
    """Per request of ``paths``: {"probs" [O, qpo], "boxes" [O, qpo, 6],
    "world" [O, qpo, 6] (the boxes' RAS world corners, mm)}."""
    q = quant or (lambda t: t)
    P = {n: w.detach() for n, w in weights.items()}
    consts = ref.constants(cfg, device)
    organs = cfg["neck"]["num_organs"]
    target = (cfg.get("preprocessing_config") or {}).get("resize_shape") \
        or cfg["augmentation"]["patch_size"]
    stats = cfg.get("foreground_voxel_statistics")
    out = []
    with exact_f32():
        for path in paths:
            x, shape, affine = prepare(path, target, stats, device)
            pred = ref.forward(P, x, cfg, consts, train=False, q=q)
            probs = torch.sigmoid(pred["pred_logits"][0, :, 0]).double()
            boxes = pred["pred_boxes"][0].double()
            probs = probs.cpu().numpy().reshape(organs, -1)
            boxes = boxes.cpu().numpy().reshape(organs, -1, 6)
            out.append({"probs": probs, "boxes": boxes,
                        "world": world_corners(boxes, shape, affine)})
    return out


def world_corners(boxes, shape, affine):
    """Normalized cxcyczwhd [..., 6] -> RAS world corners (lo, hi) [..., 6]
    in mm: the voxel extent on the RAS grid times the diagonal spacing,
    plus the origin."""
    shape = np.asarray(shape, np.float64)
    c, h = boxes[..., :3] * shape, boxes[..., 3:] * shape / 2.0
    scale = np.diag(np.asarray(affine)[:3, :3])
    off = np.asarray(affine)[:3, 3]
    return np.concatenate([(c - h) * scale + off, (c + h) * scale + off], -1)
