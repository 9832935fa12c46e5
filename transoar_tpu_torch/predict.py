"""Serving CLI of the port: raw NIfTI in -> organ detections out.

Twin of ``scripts/predict.py`` with the same flags (plus ``--device``):

    python -m transoar_tpu_torch.predict --run <experiment> \
        --input a.nii.gz b.nii.gz [--output out_dir] [--last] \
        [--save_boxmask] [--score_threshold T] [--device cuda]

Per volume: NIfTI decode and RAS reorientation, resize to the model's
training grid, the test-time intensity window, the forward under
``torch.inference_mode()``, the per-organ decode, and
``<case>_predictions.json`` with each organ's score and box as normalized
cxcyczwhd (array-axis order), voxel corners on the RAS grid and world (mm,
RAS) corners. ``--save_boxmask`` also writes the boxes as a NIfTI label
volume on the RAS grid. The run directory ``runs/<experiment>`` holds
``config.json`` and a port checkpoint (``training/checkpoints.py``). A
RetinaNet run is refused, as the JAX CLI has no decode for it; ``test``
serves that family.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np
import torch

from transoar_tpu_torch.data.nifti import load_nifti, reorient_ras, write_nifti
from transoar_tpu_torch.data.preprocessor import resize_volume
from transoar_tpu_torch.data.transforms import eval_transform
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.training import checkpoints as ckpt_lib
from transoar_tpu_torch.training.inference import inference
from transoar_tpu_torch.utils.io import set_root_logger, write_json

logger = logging.getLogger(__name__)


def load_predictor(path_to_run, prefer_best=True, device="cuda"):
    """Restore (config, model, forward) from a run directory.

    ``forward(image)`` takes a host array [B, S0, S1, S2, 1] and returns the
    model's outputs as numpy arrays."""
    device = torch.device(device)
    config = ckpt_lib.load_run_config(path_to_run)
    if "retina" in config:
        raise ValueError(
            "predict serves the one-box-per-organ decoders only: "
            "scripts/predict.py (predict_case, lines 114-122) has no "
            "RetinaNet decode either; evaluate a RetinaNet run with "
            "python -m transoar_tpu_torch.test --run <name>")
    model = build_model(config, device=device)
    ckpt = ckpt_lib.pick_checkpoint(path_to_run, prefer_best=prefer_best)
    model.load_state_dict(ckpt_lib.load_checkpoint(ckpt, device))
    model.eval()
    logger.info("restored %s on %s", ckpt, device)
    stats = config.get("foreground_voxel_statistics")

    @torch.inference_mode()
    def forward(image):
        x = torch.as_tensor(image, dtype=torch.float32).to(device)
        if stats is not None:
            x = eval_transform(x, stats)
        return {k: v.cpu().numpy() for k, v in model(x).items()}

    return config, model, forward


def prepare_volume(path, target_shape):
    """NIfTI file -> (model input [1, S0, S1, S2, 1], ras_volume, affine)."""
    img = load_nifti(path)
    ras, affine = reorient_ras(img["data"], img["affine"])
    ras = ras.astype(np.float32)
    if ras.ndim == 4:  # drop a trailing singleton time axis
        ras = ras[..., 0]
    resized = resize_volume(ras, tuple(target_shape), order=1)
    return resized[None, ..., None], ras, affine


def boxes_to_frames(boxes_norm, ras_shape, affine):
    """Normalized cxcyczwhd (array-axis order) -> voxel + world corners."""
    shape = np.asarray(ras_shape, np.float64)
    c = boxes_norm[:, :3] * shape
    h = boxes_norm[:, 3:] * shape / 2.0
    lo_vox, hi_vox = c - h, c + h
    # world (mm, RAS): the reoriented affine is diagonal scale + offset
    scale = np.diag(np.asarray(affine)[:3, :3])
    off = np.asarray(affine)[:3, 3]
    return lo_vox, hi_vox, lo_vox * scale + off, hi_vox * scale + off


def rasterize_boxes(lo_vox, hi_vox, classes, ras_shape):
    """Boxes -> label volume on the RAS grid (for viewer overlay)."""
    mask = np.zeros(ras_shape, np.int16)
    for lo, hi, cls in zip(lo_vox, hi_vox, classes):
        lo_i = np.clip(np.floor(lo).astype(int), 0, np.array(ras_shape) - 1)
        hi_i = np.clip(np.ceil(hi).astype(int), 1, np.array(ras_shape))
        slc = tuple(slice(a, b) for a, b in zip(lo_i, hi_i))
        mask[slc] = int(cls)
    return mask


def predict_case(input_path, config, forward, score_threshold=0.0):
    """Returns (detections, (lo_vox, hi_vox, classes), ras_shape, affine,
    forward_seconds)."""
    target = (config.get("preprocessing_config", {}) or {}).get(
        "resize_shape") or config["augmentation"]["patch_size"]
    image, ras, affine = prepare_volume(input_path, target)

    t0 = time.perf_counter()
    out = forward(image)  # ends with the copy to the host
    forward_s = time.perf_counter() - t0
    boxes, classes, scores = inference(out, config["neck"]["num_organs"])
    boxes, classes, scores = boxes[0], classes[0], scores[0]
    keep = scores >= score_threshold
    boxes, classes, scores = boxes[keep], classes[keep], scores[keep]

    lo_v, hi_v, lo_w, hi_w = boxes_to_frames(boxes, ras.shape, affine)
    labels = config.get("labels", {})
    detections = [{
        "class": int(cls),
        "name": labels.get(str(int(cls)), f"class{int(cls)}"),
        "score": float(s),
        "box_cxcyczwhd_norm": [float(v) for v in box],
        "voxel_lo": [float(v) for v in lo],
        "voxel_hi": [float(v) for v in hi],
        "world_mm_lo": [float(v) for v in wl],
        "world_mm_hi": [float(v) for v in wh],
    } for cls, s, box, lo, hi, wl, wh in zip(
        classes, scores, boxes, lo_v, hi_v, lo_w, hi_w)]
    return detections, (lo_v, hi_v, classes), ras.shape, affine, forward_s


def main(argv=None):
    """Serve every ``--input``; returns one record per case: the input, its
    detections, and the forward and end-to-end seconds."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--run", type=str, required=True,
                        help="Experiment name under ./runs.")
    parser.add_argument("--input", type=str, required=True, nargs="+",
                        help="One or more .nii/.nii.gz volumes.")
    parser.add_argument("--output", type=str, default=None,
                        help="Output dir (default runs/<run>/predictions).")
    parser.add_argument("--last", action="store_true",
                        help="Use model_last instead of the best checkpoint.")
    parser.add_argument("--score_threshold", type=float, default=0.0)
    parser.add_argument("--save_boxmask", action="store_true",
                        help="Also write the boxes as a NIfTI label volume "
                             "on the RAS input grid.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device of the forward (default cuda).")
    args = parser.parse_args(argv)

    set_root_logger(Path.cwd() / "logs" / "predict.log")
    path_to_run = Path.cwd() / "runs" / args.run
    out_dir = Path(args.output) if args.output else \
        path_to_run / "predictions"
    out_dir.mkdir(parents=True, exist_ok=True)

    config, _, forward = load_predictor(path_to_run, not args.last,
                                        args.device)
    records = []
    for inp in args.input:
        t0 = time.perf_counter()
        stem = Path(inp).name.replace(".nii.gz", "").replace(".nii", "")
        detections, (lo_v, hi_v, classes), ras_shape, affine, fwd_s = \
            predict_case(inp, config, forward, args.score_threshold)
        out_path = out_dir / f"{stem}_predictions.json"
        write_json({"input": str(inp), "run": args.run,
                    "detections": detections}, out_path)
        if args.save_boxmask:
            mask = rasterize_boxes(lo_v, hi_v, classes, ras_shape)
            write_nifti(mask, out_dir / f"{stem}_boxmask.nii.gz",
                        affine=affine)
        total_s = time.perf_counter() - t0
        logger.info("%s: %d detections, forward %.1f ms, total %.1f ms",
                    stem, len(detections), 1e3 * fwd_s, 1e3 * total_s)
        print(f"{stem}: {len(detections)} detections -> {out_path}")
        records.append({"input": str(inp), "detections": detections,
                        "forward_s": fwd_s, "total_s": total_s})
    return records


if __name__ == "__main__":
    main()
