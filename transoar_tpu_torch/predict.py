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

A volume is prepared where it is served. With a CUDA device (the default
of ``predict_case`` when a card is present, and ``--device cuda``) the host
only inflates the file's raw integers into a pinned staging buffer; one
copy takes them to the card, which casts them to f32, applies the scl slope
and intercept, transposes and flips them to RAS and resizes them to the
model's grid (``prepare_on_device``). Any other device takes the host path
(``prepare_volume``: the copies of the JAX ``load_nifti``, ``reorient_ras``
and scipy zoom, bit for bit as ``scripts/predict.py``). Both resample with
linear weights on the pixel-edge grid, edges extended. ``prepared`` counts
the requests each path took.

Under a torch profiler ``predict_case`` marks its phases as spans
(``utils/spans.py``). On the card path: ``predict.read`` (the header and the
raw inflate), ``predict.reorient`` (the RAS plan from the affine and the
upload), ``predict.resize`` (the enqueue of the device chain: cast, scale,
transpose, flips, trilinear resize). On the host path: ``predict.read``
(NIfTI open, inflate, header, the f32 cast), ``predict.reorient`` (RAS
transpose and flips, a second f32 copy), ``predict.resize`` (the zoom to
the model's grid). Both: ``predict.forward`` (the region
``forward_seconds`` times: the copy to the card where the volume is on the
host, the window, the model, the copy back; on the card path it also waits
for the upload and the device chain) and ``predict.decode`` (the per-organ
decode and the detection records).
"""

from __future__ import annotations

import argparse
import gzip
import logging
import struct
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from transoar_tpu_torch.data.nifti import load_nifti, reorient_ras, write_nifti
from transoar_tpu_torch.data.preprocessor import resize_volume
from transoar_tpu_torch.data.transforms import eval_transform
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.training import checkpoints as ckpt_lib
from transoar_tpu_torch.training.inference import inference
from transoar_tpu_torch.utils.io import set_root_logger, write_json
from transoar_tpu_torch.utils.spans import span

logger = logging.getLogger(__name__)

# the requests each path prepared: "card" (prepare_on_device on a CUDA
# device) and "host" (prepare_volume)
prepared = dict.fromkeys(("card", "host"), 0)
# NIfTI datatype code -> the torch dtype of its voxels (data/nifti.py's set)
_TORCH_DTYPES = {
    2: torch.uint8, 4: torch.int16, 8: torch.int32, 16: torch.float32,
    64: torch.float64, 256: torch.int8, 512: torch.uint16, 768: torch.uint32,
    1024: torch.int64, 1280: torch.uint64,
}
# per thread: the pinned buffer the raw voxels are inflated into, and the
# event after the last upload out of it
_staging = threading.local()


def load_predictor(path_to_run, prefer_best=True, device="cuda"):
    """Restore (config, model, forward) from a run directory.

    ``forward(image)`` takes a host array or a tensor [B, S0, S1, S2, 1] (one
    already on ``device`` is not copied) and returns the model's outputs as
    numpy arrays."""
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
    with span("predict.read"):
        img = load_nifti(path)
    with span("predict.reorient"):
        ras, affine = reorient_ras(img["data"], img["affine"])
        ras = ras.astype(np.float32)
        if ras.ndim == 4:  # drop a trailing singleton time axis
            ras = ras[..., 0]
    with span("predict.resize"):
        resized = resize_volume(ras, tuple(target_shape), order=1)
    return resized[None, ..., None], ras, affine


class RawVolume(NamedTuple):
    """A NIfTI file's first volume as stored: ``data`` holds its voxel bytes
    (uint8 [X * Y * Z * itemsize], little-endian as ``load_nifti`` reads
    them, x fastest)."""
    data: torch.Tensor
    dtype: torch.dtype
    shape: tuple      # (X, Y, Z)
    affine: np.ndarray
    scale: tuple | None  # (scl_slope, scl_inter) where load_nifti applies it


class RasPlan(NamedTuple):
    """``reorient_ras``'s reorientation as a plan: the RAS volume is the file
    volume's axes ``axes`` (RAS axis a = file axis axes[a]) flipped along
    ``flips``, with ``affine`` and ``shape``."""
    axes: tuple
    flips: tuple
    affine: np.ndarray
    shape: tuple


def _stage(nbytes, device):
    """A host byte buffer to read ``nbytes`` voxel bytes into: for a CUDA
    device this thread's pinned buffer, reused across requests and grown
    to the next power of two when a larger volume arrives (the rounding of
    torch's pinned allocator); otherwise a fresh one."""
    if device.type != "cuda":
        return torch.empty(nbytes, dtype=torch.uint8)
    uploaded = getattr(_staging, "uploaded", None)
    if uploaded is not None:
        uploaded.synchronize()  # the last upload out of the buffer is done
    buf = getattr(_staging, "buf", None)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(1 << (nbytes - 1).bit_length(), dtype=torch.uint8,
                          pin_memory=True)
        _staging.buf = buf
    return buf[:nbytes]


def read_raw(path, device):
    """The header of a .nii / .nii.gz file and its first volume's voxel
    bytes, inflated into ``_stage``'s buffer with no cast: the fields
    ``load_nifti`` reads, parsed as it parses them."""
    path = str(path)
    with (gzip.open(path, "rb") if path.endswith(".gz")
          else open(path, "rb")) as f:
        header = f.read(348)
        if len(header) < 348:
            raise ValueError(f"truncated NIfTI header: {path}")
        sizeof_hdr = struct.unpack("<i", header[:4])[0]
        if sizeof_hdr != 348:
            raise ValueError(f"not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
        dim = struct.unpack("<8h", header[40:56])
        datatype = struct.unpack("<h", header[70:72])[0]
        pixdim = struct.unpack("<8f", header[76:108])
        vox_offset = struct.unpack("<f", header[108:112])[0]
        slope, inter = struct.unpack("<2f", header[112:120])
        sform_code = struct.unpack("<h", header[254:256])[0]
        srow = np.array(struct.unpack("<12f", header[280:328])).reshape(3, 4)
        if datatype not in _TORCH_DTYPES:
            raise ValueError(f"unsupported NIfTI datatype {datatype}")
        dtype = _TORCH_DTYPES[datatype]
        shape = tuple(dim[1:1 + max(dim[0], 3)])
        if len(shape) > 4:
            raise ValueError(f"expected a 3-D or 4-D volume, got {shape}")
        # x fastest: a 4-D file's first volume is its first X * Y * Z voxels
        shape = shape[:3]
        nbytes = int(np.prod(shape)) * dtype.itemsize
        f.seek(int(vox_offset))
        data = _stage(nbytes, device)
        if f.readinto(data.numpy()) != nbytes:
            raise ValueError(f"truncated NIfTI voxel data: {path}")

    scaled = (slope != 0.0 and np.isfinite(slope) and np.isfinite(inter)
              and (slope, inter) != (1.0, 0.0))
    if sform_code > 0:
        affine = np.vstack([srow, [0, 0, 0, 1]])
    else:
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])
    return RawVolume(data, dtype, shape, affine.astype(np.float64),
                     (slope, inter) if scaled else None)


def ras_plan(affine, shape):
    """``reorient_ras``'s axis order, flips, affine and shape, derived from
    the affine as it derives them, without a voxel."""
    rot = affine[:3, :3]
    # voxel axis j maps mostly to world axis argmax(|rot[:, j]|)
    perm = np.argmax(np.abs(rot), axis=0)
    if len(set(perm.tolist())) != 3:
        perm = np.array([0, 1, 2])
    inv = np.argsort(perm)
    rot = rot[:, inv]
    flips = tuple(a for a in range(3) if rot[a, a] < 0)
    ras_affine = np.eye(4)
    for a in range(3):
        ras_affine[a, a] = abs(rot[a, a])
    ras_affine[:3, 3] = affine[:3, 3]
    axes = tuple(int(i) for i in inv)
    return RasPlan(axes, flips, ras_affine, tuple(shape[i] for i in axes))


def prepare_on_device(path, target_shape, device):
    """NIfTI file -> (model input [1, S0, S1, S2, 1] f32 on ``device``,
    RAS shape, RAS affine): the raw voxels go to ``device`` in one copy,
    which casts them to f32, scales them as ``load_nifti`` does, transposes
    and flips them to RAS and resizes them (trilinear in f32 on the
    pixel-edge grid, edges extended: ``resize_volume``'s grid)."""
    device = torch.device(device)
    with span("predict.read"):
        raw = read_raw(path, device)
    with span("predict.reorient"):
        plan = ras_plan(raw.affine, raw.shape)
        data = raw.data.to(device, non_blocking=True)
        if device.type == "cuda":
            _staging.uploaded = torch.cuda.Event()
            _staging.uploaded.record(torch.cuda.current_stream(device))
    with span("predict.resize"):
        x = data.view(raw.dtype).view(raw.shape[::-1]).permute(2, 1, 0)
        x = x.float()  # [X, Y, Z]
        if raw.scale is not None:
            x = x * raw.scale[0] + raw.scale[1]
        x = x.permute(plan.axes)
        if plan.flips:
            x = x.flip(plan.flips)
        x = F.interpolate(x[None, None], size=tuple(target_shape),
                          mode="trilinear", align_corners=False)
    return x.view(1, *target_shape, 1), plan.shape, plan.affine


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


def predict_case(input_path, config, forward, score_threshold=0.0,
                 device=None):
    """Returns (detections, (lo_vox, hi_vox, classes), ras_shape, affine,
    forward_seconds). ``device`` is where the volume is prepared: a CUDA
    device takes ``prepare_on_device``, any other ``prepare_volume``; None
    is the card where one is present."""
    target = (config.get("preprocessing_config", {}) or {}).get(
        "resize_shape") or config["augmentation"]["patch_size"]
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        image, ras_shape, affine = prepare_on_device(input_path, target,
                                                     device)
        prepared["card"] += 1
    else:
        image, ras, affine = prepare_volume(input_path, target)
        ras_shape = ras.shape
        prepared["host"] += 1

    with span("predict.forward"):
        t0 = time.perf_counter()
        out = forward(image)  # ends with the copy to the host
        forward_s = time.perf_counter() - t0
    with span("predict.decode"):
        boxes, classes, scores = inference(out, config["neck"]["num_organs"])
        boxes, classes, scores = boxes[0], classes[0], scores[0]
        keep = scores >= score_threshold
        boxes, classes, scores = boxes[keep], classes[keep], scores[keep]

        lo_v, hi_v, lo_w, hi_w = boxes_to_frames(boxes, ras_shape, affine)
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
    return detections, (lo_v, hi_v, classes), ras_shape, affine, forward_s


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
            predict_case(inp, config, forward, args.score_threshold,
                         args.device)
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
