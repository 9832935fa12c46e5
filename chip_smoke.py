"""On-card smoke test of the PyTorch/CUDA port (transoar_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the repository around it; imports no jax. Phases,
each printing a line; any failure exits non-zero before the result lines:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile every CUDA kernel of the serving path from csrc/;
3. kernel vs plain: packed_conv against packed_conv_reference at the
   flagship's two stage-0 shapes and one ragged shape, bf16, with the median
   time of each over 20 runs (and of cuDNN's bf16 conv, for scale);
4. small model, CPU vs card: a tiny f32 flagship-shaped model with the same
   seeded weights on the CPU (plain versions) and on the card (kernel),
   TF32 off; logits within 1e-3, boxes within 1e-4;
5. serving: the full-width foc_dec_amos model (256x256x128, bf16, seeded
   random weights) saved as a run directory, then
   ``transoar_tpu_torch.predict.main`` on three synthetic NIfTI volumes off
   the training grid; 15 valid detections each, and packed_conv launched
   twice per volume.

Then one JSON line of per-kernel results and, last, the device line
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
# the flagship's two packed stage-0 band convs at 256x256x128, batch 1:
# [B*D/4, H, W, 6*C_in] -> 4*24 channels
MAIN_SHAPES = [((64, 256, 128, 6), 96), ((64, 256, 128, 144), 96)]
RAGGED_SHAPE = ((3, 13, 70, 10), 40)
# request volumes off the 256x256x128 grid, so the resize runs
VOLUME_SHAPES = [(300, 280, 150), (240, 236, 110), (280, 300, 140)]
N_REQUESTS = len(VOLUME_SHAPES)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase_device():
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    # f32 references in full f32: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def phase_build():
    from transoar_tpu_torch.ops.kernels._build import build_log, load_library

    t0 = time.perf_counter()
    load_library("packed_conv")
    secs = time.perf_counter() - t0
    ptxas = [l.strip() for l in build_log("packed_conv").splitlines()
             if "registers" in l]
    print(f"build: packed_conv.cu in {secs:.2f} s; " + " | ".join(ptxas),
          flush=True)


def _median_ms(fn, runs=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel():
    from transoar_tpu_torch.ops.kernels.packed_conv import (
        packed_conv, packed_conv_reference)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for shape, cout in MAIN_SHAPES + [RAGGED_SHAPE]:
        cin = shape[-1]
        xh = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        wp = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
              / (9 * cin) ** 0.5).bfloat16()
        ours = packed_conv(xh, wp)
        ref = packed_conv_reference(xh, wp)
        torch.cuda.synchronize()
        torch.testing.assert_close(ours, ref, rtol=1.6e-2, atol=1e-2)
        row = {"shape": list(shape), "cout": cout,
               "max_abs_err": (ours.float() - ref.float()).abs().max().item()}
        if (shape, cout) in MAIN_SHAPES:
            x_nchw = xh.permute(0, 3, 1, 2)  # channels-last view
            w_oihw = wp.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            row["ms"] = _median_ms(lambda: packed_conv(xh, wp))
            row["plain_ms"] = _median_ms(
                lambda: packed_conv_reference(xh, wp))
            row["cudnn_bf16_ms"] = _median_ms(
                lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1))
        rows.append(row)
        print(f"kernel: packed_conv {json.dumps(row)}", flush=True)
        del xh, wp, ours, ref
    torch.cuda.empty_cache()
    return rows


def phase_small_model():
    from transoar_tpu_torch.models.transoarnet import build_model
    from transoar_tpu_torch.ops.kernels.packed_conv import packed_conv
    from transoar_tpu_torch.presets import tiny_flagship_config
    from transoar_tpu_torch.utils.weights import random_state_dict

    cfg = tiny_flagship_config()
    assert cfg["backbone"]["stage0_pack"] == 4
    outs = {}
    for device in ("cpu", "cuda"):
        model = build_model(cfg, dtype=torch.float32, device=device)
        model.load_state_dict(random_state_dict(model, SEED))
        x = np.random.default_rng(SEED).normal(
            size=(1, *cfg["augmentation"]["patch_size"], 1))
        before = packed_conv.launches
        with torch.inference_mode():
            out = model(torch.as_tensor(x, dtype=torch.float32,
                                        device=device))
        torch.cuda.synchronize()
        launched = packed_conv.launches - before
        if launched != (2 if device == "cuda" else 0):
            fail(f"small model on {device}: {launched} packed_conv launches")
        outs[device] = {k: v.cpu() for k, v in out.items()}
    errs = {}
    for key, tol in (("pred_logits", 1e-3), ("aux_logits", 1e-3),
                     ("pred_boxes", 1e-4), ("aux_boxes", 1e-4)):
        torch.testing.assert_close(outs["cuda"][key], outs["cpu"][key],
                                   rtol=0, atol=tol)
        errs[key] = (outs["cuda"][key] - outs["cpu"][key]).abs().max().item()
    print(f"small model: card vs CPU max abs diff {json.dumps(errs)}",
          flush=True)


def phase_serving():
    from transoar_tpu_torch import predict
    from transoar_tpu_torch.ops.kernels.packed_conv import packed_conv
    from transoar_tpu_torch.presets import (flagship_config, save_random_run,
                                            write_ct_volumes)

    cfg = flagship_config()
    cfg["foreground_voxel_statistics"] = {"percentile_00_5": -1000.0,
                                          "percentile_99_5": 1000.0}
    organs = cfg["neck"]["num_organs"]
    with tempfile.TemporaryDirectory() as tmp:
        save_random_run(cfg, Path(tmp) / "runs" / "foc_dec_amos", SEED)
        inputs = write_ct_volumes(tmp, VOLUME_SHAPES, SEED)

        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            torch.cuda.reset_peak_memory_stats()
            packed_conv.launches = 0
            records = predict.main(["--run", "foc_dec_amos", "--input",
                                    *inputs])
            launches = packed_conv.launches
        finally:
            os.chdir(cwd)
    peak = torch.cuda.max_memory_allocated()

    if len(records) != N_REQUESTS:
        fail(f"serving answered {len(records)} of {N_REQUESTS} requests")
    for rec in records:
        dets = rec["detections"]
        if len(dets) != organs:
            fail(f"{rec['input']}: {len(dets)} detections, want {organs}")
        scores = np.array([d["score"] for d in dets])
        boxes = np.array([d["box_cxcyczwhd_norm"] for d in dets])
        if not (np.isfinite(scores).all() and np.isfinite(boxes).all()):
            fail(f"{rec['input']}: non-finite scores or boxes")
        if boxes.min() < 0.0 or boxes.max() > 1.0:
            fail(f"{rec['input']}: boxes outside [0, 1]")
        if sorted(d["class"] for d in dets) != list(range(1, organs + 1)):
            fail(f"{rec['input']}: not one detection per organ")
    if launches != 2 * N_REQUESTS:
        fail(f"serving launched packed_conv {launches} times, want "
             f"{2 * N_REQUESTS}")
    fwd = [1e3 * r["forward_s"] for r in records]
    tot = [1e3 * r["total_s"] for r in records]
    grid = "x".join(map(str, cfg["augmentation"]["patch_size"]))
    print(f"serving: {N_REQUESTS} requests at {grid}, {organs} "
          f"detections each; forward ms {fwd} (median "
          f"{statistics.median(fwd):.1f}); end to end ms {tot} (median "
          f"{statistics.median(tot):.1f}); peak device memory "
          f"{peak / 2**30:.2f} GiB; packed_conv launches {launches}",
          flush=True)
    return launches


def main():
    phase_device()
    phase_build()
    rows = phase_kernel()
    phase_small_model()
    launches = phase_serving()
    main_rows = [r for r in rows if "ms" in r]
    kernels = [{
        "name": "packed_conv",
        "route": "cuda",
        "source": "transoar_tpu_torch/csrc/packed_conv.cu",
        "replaces": "transoar_tpu/ops/pallas/packed_conv.py:166",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # per volume: the two main-path shapes, one launch each
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "shapes": main_rows,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
