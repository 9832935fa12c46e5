"""On-card smoke test of the PyTorch/CUDA port (transoar_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the repository around it; imports no jax. Phases,
each printing a line; any failure exits non-zero before the result lines:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from csrc/;
3. forward kernel vs plain: packed_conv against packed_conv_reference at
   the flagship's stage-0 shapes (serving batch 1, training batch 2) and a
   ragged shape, bf16, with the median time of each over 20 runs, of
   cuDNN's bf16 conv for scale, and the card's bound for the same work;
4. backward kernels vs plain: packed_conv_dx (bf16, rtol 1.6e-2 atol
   1e-2) and packed_conv_dw (f32 result, rel-L2 <= 1e-4 against the f32
   plain version of the same bf16 inputs, and bit-identical when run
   twice) at the training shapes and a ragged shape, timed as phase 3
   (cuDNN's conv2d_input / conv2d_weight for scale);
5. small model, CPU vs card: a tiny f32 flagship-shaped model with the same
   seeded weights on the CPU (plain versions) and on the card (kernels),
   TF32 off; logits within 1e-3, boxes within 1e-4;
6. small train step, CPU vs card: the same tiny model at batch 2, f32, in
   eval() mode (no dropout); loss rtol 1e-4, per-tensor gradient rel-L2 <
   1e-3, the AdamW step's deltas within rtol 0.05 / atol 0.25 x lr; the
   card's step launches forward 4 / dx 1 / dw 2 (remat recomputes stage 0);
7. serving: the full-width foc_dec_amos model (256x256x128, bf16, seeded
   random weights) saved as a run directory, then
   ``transoar_tpu_torch.predict.main`` on three synthetic NIfTI volumes off
   the training grid; 15 valid detections each, and packed_conv launched
   twice per volume;
8. training: ``transoar_tpu_torch.train.train`` on full-width foc_dec_amos
   at batch 2 (bf16, augmentation off) over a synthetic 256x256x128
   dataset of 8 train and 2 val cases written to a temporary directory: 2
   epochs = 8 steps + 3 validations; finite losses, changed parameters,
   ``model_last.pt`` written, and per step 4 / 1 / 2 launches of the
   forward / dx / dw kernels; the step-time median (device time, without
   the first step), and per epoch the train loop's volumes/s over its wall
   time (loader and copies included) and the share of that wall time the
   compute stream spends outside the steps; peak device memory.

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
from types import SimpleNamespace

import numpy as np
import torch

SEED = 0
# the flagship's two packed stage-0 band convs at 256x256x128:
# [B*D/4, H, W, 6*C_in] -> 4*24 channels; serving batch 1, training batch 2
SERVING_SHAPES = [((64, 256, 128, 6), 96), ((64, 256, 128, 144), 96)]
TRAIN_SHAPES = [((128, 256, 128, 6), 96), ((128, 256, 128, 144), 96)]
RAGGED_SHAPE = ((3, 13, 70, 10), 40)
# request volumes off the 256x256x128 grid, so the resize runs
VOLUME_SHAPES = [(300, 280, 150), (240, 236, 110), (280, 300, 140)]
N_REQUESTS = len(VOLUME_SHAPES)
TRAIN_CASES, VAL_CASES, EPOCHS, BATCH = 8, 2, 2, 2
# launches per train step at batch 2 with encoder remat (forward, dx, dw)
STEP_LAUNCHES = (4, 1, 2)
# the card's published dense peaks (H100 SXM data sheet, 700 W)
PEAK_BF16_FLOPS, PEAK_BYTES_S = 989e12, 3.35e12


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _kernels():
    from transoar_tpu_torch.ops.kernels import packed_conv as pc

    return pc


def _launches():
    pc = _kernels()
    return (pc.packed_conv.launches, pc.packed_conv_dx.launches,
            pc.packed_conv_dw.launches)


def _reset_launches():
    pc = _kernels()
    pc.packed_conv.launches = 0
    pc.packed_conv_dx.launches = 0
    pc.packed_conv_dw.launches = 0


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


def _bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of compute and memory time at the
    card's published peaks."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _conv_work(shape, cin, cout):
    """(flops, pixels) of one band conv product over ``shape``'s pixels."""
    pixels = shape[0] * shape[1] * shape[2]
    return 2 * pixels * 9 * cin * cout, pixels


def _inputs(gen, shape, cout):
    cin = shape[-1]
    xh = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    wp = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
          / (9 * cin) ** 0.5).bfloat16()
    return xh, wp


def phase_kernel():
    pc = _kernels()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for shape, cout in SERVING_SHAPES + TRAIN_SHAPES + [RAGGED_SHAPE]:
        cin = shape[-1]
        xh, wp = _inputs(gen, shape, cout)
        ours = pc.packed_conv(xh, wp)
        ref = pc.packed_conv_reference(xh, wp)
        torch.cuda.synchronize()
        torch.testing.assert_close(ours, ref, rtol=1.6e-2, atol=1e-2)
        row = {"shape": list(shape), "cout": cout,
               "max_abs_err": (ours.float() - ref.float()).abs().max().item()}
        del ours, ref
        if (shape, cout) != RAGGED_SHAPE:
            flops, pixels = _conv_work(shape, cin, cout)
            row["bound_ms"], row["bound_by"] = _bound(
                flops, 2 * pixels * (cin + cout) + 2 * wp.numel())
            x_nchw = xh.permute(0, 3, 1, 2)  # channels-last view
            w_oihw = wp.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            row["ms"] = _median_ms(lambda: pc.packed_conv(xh, wp))
            row["plain_ms"] = _median_ms(
                lambda: pc.packed_conv_reference(xh, wp))
            row["library_ms"] = _median_ms(
                lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1))
            row["path"] = ("training" if (shape, cout) in TRAIN_SHAPES
                           else "serving")
        rows.append(row)
        print(f"kernel: packed_conv {json.dumps(row)}", flush=True)
        del xh, wp
        torch.cuda.empty_cache()
    return rows


def _rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def phase_backward():
    pc = _kernels()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dx_rows, dw_rows = [], []
    for shape, cout in TRAIN_SHAPES + [RAGGED_SHAPE]:
        cin = shape[-1]
        timed = (shape, cout) != RAGGED_SHAPE
        xh, wp = _inputs(gen, shape, cout)
        dy = torch.randn((*shape[:3], cout), generator=gen,
                         device="cuda").bfloat16()
        flops, pixels = _conv_work(shape, cin, cout)

        # dx: only the second stage-0 conv's input needs it (Cin = 144)
        if cin != 6:
            dx = pc.packed_conv_dx(dy, wp)
            ref = pc.packed_conv_dx_reference(dy, wp)
            torch.cuda.synchronize()
            torch.testing.assert_close(dx, ref, rtol=1.6e-2, atol=1e-2)
            row = {"shape": list(dy.shape), "cout": cin,
                   "max_abs_err": (dx.float() - ref.float()).abs().max()
                   .item()}
            del dx, ref
            if timed:
                row["bound_ms"], row["bound_by"] = _bound(
                    flops, 2 * pixels * (cin + cout) + 2 * wp.numel())
                dy_nchw = dy.permute(0, 3, 1, 2)
                w_oihw = wp.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                in_shape = (shape[0], cin, shape[1], shape[2])
                row["ms"] = _median_ms(lambda: pc.packed_conv_dx(dy, wp))
                row["plain_ms"] = _median_ms(
                    lambda: pc.packed_conv_dx_reference(dy, wp))
                row["library_ms"] = _median_ms(
                    lambda: torch.nn.grad.conv2d_input(
                        in_shape, w_oihw, dy_nchw, padding=1))
            dx_rows.append(row)
            print(f"backward: packed_conv_dx {json.dumps(row)}", flush=True)

        dw = pc.packed_conv_dw(xh, dy)
        again = pc.packed_conv_dw(xh, dy)
        ref = pc.packed_conv_dw_reference(xh, dy)
        torch.cuda.synchronize()
        rel = _rel_l2(dw, ref)
        if dw.dtype != torch.float32 or rel > 1e-4:
            fail(f"packed_conv_dw at {shape}x{cout}: rel-L2 {rel:.2e}")
        if not torch.equal(dw, again):
            fail(f"packed_conv_dw at {shape}x{cout} is not deterministic")
        row = {"shape": list(shape), "cout": cout, "rel_l2": rel,
               "max_abs_err": (dw - ref).abs().max().item(),
               "bit_identical_rerun": True}
        del dw, again, ref
        if timed:
            row["bound_ms"], row["bound_by"] = _bound(
                flops, 2 * pixels * (cin + cout) + 4 * 9 * cin * cout)
            x_nchw = xh.permute(0, 3, 1, 2)
            dy_nchw = dy.permute(0, 3, 1, 2)
            row["ms"] = _median_ms(lambda: pc.packed_conv_dw(xh, dy))
            row["plain_ms"] = _median_ms(
                lambda: pc.packed_conv_dw_reference(xh, dy))
            row["library_ms"] = _median_ms(
                lambda: torch.nn.grad.conv2d_weight(
                    x_nchw, (cout, cin, 3, 3), dy_nchw, padding=1))
        dw_rows.append(row)
        print(f"backward: packed_conv_dw {json.dumps(row)}", flush=True)
        del xh, wp, dy
        torch.cuda.empty_cache()
    return dx_rows, dw_rows


def phase_small_model():
    from transoar_tpu_torch.models.transoarnet import build_model
    from transoar_tpu_torch.presets import tiny_flagship_config
    from transoar_tpu_torch.utils.weights import random_state_dict

    cfg = tiny_flagship_config()
    assert cfg["backbone"]["stage0_pack"] == 4
    outs = {}
    for device in ("cpu", "cuda"):
        model = build_model(cfg, dtype=torch.float32, device=device).eval()
        model.load_state_dict(random_state_dict(model, SEED))
        x = np.random.default_rng(SEED).normal(
            size=(1, *cfg["augmentation"]["patch_size"], 1))
        before = _launches()[0]
        with torch.inference_mode():
            out = model(torch.as_tensor(x, dtype=torch.float32,
                                        device=device))
        torch.cuda.synchronize()
        launched = _launches()[0] - before
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


def _small_train_step(cfg, device, batch):
    from transoar_tpu_torch.models.criterion import build_criterion
    from transoar_tpu_torch.models.transoarnet import build_model
    from transoar_tpu_torch.training.train_state import make_optimizer
    from transoar_tpu_torch.training.trainer import make_train_step
    from transoar_tpu_torch.utils.weights import random_state_dict

    model = build_model(cfg, dtype=torch.float32, device=device).eval()
    model.load_state_dict(random_state_dict(model, SEED))
    before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    optimizer, scheduler = make_optimizer(model, cfg, 1)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg)
    counts = _launches()
    losses = step({k: torch.as_tensor(v, device=device)
                   for k, v in batch.items()})
    torch.cuda.synchronize()
    launched = tuple(b - a for a, b in zip(counts, _launches()))
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    after = {n: p.detach().cpu() for n, p in model.named_parameters()}
    return float(losses["total"]), grads, before, after, launched


def phase_small_train():
    from transoar_tpu_torch.data.synthetic import make_case
    from transoar_tpu_torch.presets import tiny_flagship_config

    cfg = tiny_flagship_config()
    cfg["trainer"]["precision"] = "float32"
    cfg["augmentation"]["use_augmentation"] = False
    rng = np.random.default_rng(SEED)
    cases = [make_case(rng, cfg["augmentation"]["patch_size"],
                       cfg["bbox_properties"]) for _ in range(BATCH)]
    batch = {"image": np.stack([c[0] for c in cases])[..., None],
             "seg": np.stack([c[1] for c in cases])}
    cpu = _small_train_step(cfg, "cpu", batch)
    card = _small_train_step(cfg, "cuda", batch)
    if cpu[4] != (0, 0, 0) or card[4] != STEP_LAUNCHES:
        fail(f"small train step launches: CPU {cpu[4]}, card {card[4]}, "
             f"want (0, 0, 0) and {STEP_LAUNCHES}")
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    if loss_rel > 1e-4:
        fail(f"small train step loss: card {card[0]} vs CPU {cpu[0]}")
    total = torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in cpu[1].values()])).item()
    floor = 1e-5 * total
    worst, negligible = 0.0, set()
    for name, g in cpu[1].items():
        ours = card[1][name]
        if g.norm() < floor and ours.norm() < floor:
            negligible.add(name)
            continue
        rel = ((ours - g).norm() / max(g.norm().item(), floor)).item()
        worst = max(worst, rel)
        if rel >= 1e-3:
            fail(f"small train step gradient {name}: rel-L2 {rel:.2e}")
    lrs = {"backbone": float(cfg["trainer"]["lr_backbone"]),
           "neck": float(cfg["trainer"]["lr"])}
    for name, g in cpu[1].items():
        if name in negligible:
            continue
        # entries with a gradient at float-noise level (the self-attention
        # key bias inside in_proj_bias: analytically zero) have no defined
        # AdamW direction, g / (|g| + eps); compare the others
        decided = g.abs() > 1e-4 * g.abs().max()
        lr = lrs["backbone" if name.startswith("_backbone.") else "neck"]
        torch.testing.assert_close(
            (card[3][name] - card[2][name])[decided],
            (cpu[3][name] - cpu[2][name])[decided], rtol=0.05, atol=0.25 * lr)
    print(f"small train step: card vs CPU loss rel {loss_rel:.2e}, worst "
          f"gradient rel-L2 {worst:.2e} over {len(cpu[1]) - len(negligible)} "
          f"tensors, AdamW deltas within tolerance; card launches "
          f"forward/dx/dw {card[4]}", flush=True)


def phase_serving():
    from transoar_tpu_torch import predict
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
            _reset_launches()
            records = predict.main(["--run", "foc_dec_amos", "--input",
                                    *inputs])
            launches = _launches()
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
    if launches != (2 * N_REQUESTS, 0, 0):
        fail(f"serving launched forward/dx/dw {launches} times, want "
             f"({2 * N_REQUESTS}, 0, 0)")
    fwd = [1e3 * r["forward_s"] for r in records]
    tot = [1e3 * r["total_s"] for r in records]
    grid = "x".join(map(str, cfg["augmentation"]["patch_size"]))
    print(f"serving: {N_REQUESTS} requests at {grid}, {organs} "
          f"detections each; forward ms {fwd} (median "
          f"{statistics.median(fwd):.1f}); end to end ms {tot} (median "
          f"{statistics.median(tot):.1f}); peak device memory "
          f"{peak / 2**30:.2f} GiB; packed_conv launches {launches[0]}",
          flush=True)
    return launches


def phase_training():
    from transoar_tpu_torch import train
    from transoar_tpu_torch.data.synthetic import generate_dataset
    from transoar_tpu_torch.models.transoarnet import build_model
    from transoar_tpu_torch.presets import flagship_config
    from transoar_tpu_torch.utils.io import load_json

    cfg = flagship_config(batch_size=BATCH)
    cfg.update(experiment_name="foc_dec_amos_smoke", dataset="synthetic",
               debug_mode=False)
    cfg["augmentation"]["use_augmentation"] = False
    cfg["trainer"].update(epochs=EPOCHS, val_interval=1)
    organs = cfg["neck"]["num_organs"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ds = generate_dataset(
            Path(tmp) / "dataset", name="synthetic",
            shape=tuple(cfg["augmentation"]["patch_size"]),
            num_classes=organs, num_train=TRAIN_CASES, num_val=VAL_CASES,
            num_test=0, seed=SEED)
        cfg.update(load_json(ds / "data_info.json"))
        data_s = time.perf_counter() - t0

        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t0 = time.perf_counter()
            trainer = train.train(cfg, SimpleNamespace(
                device="cuda", data_dir=str(Path(tmp) / "dataset"),
                resume=None, auto_resume=False))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = _launches()
            peak = torch.cuda.max_memory_allocated()
            last = Path(tmp) / "runs" / cfg["experiment_name"] / \
                "model_last.pt"
            if not last.exists():
                fail("training wrote no model_last.pt")
        finally:
            os.chdir(cwd)

    steps = EPOCHS * (TRAIN_CASES // BATCH)
    val_batches = (EPOCHS + 1) * (VAL_CASES // BATCH)
    want = (STEP_LAUNCHES[0] * steps + 2 * val_batches,
            STEP_LAUNCHES[1] * steps, STEP_LAUNCHES[2] * steps)
    if launches != want:
        fail(f"training launched forward/dx/dw {launches}, want {want}")
    train_losses = [h["train"]["total"] for h in trainer.history
                    if "train" in h]
    if len(train_losses) != EPOCHS or not np.isfinite(train_losses).all():
        fail(f"training losses {train_losses}")
    fresh = build_model(cfg, device="cpu", generator=torch.Generator()
                        .manual_seed(int(cfg["seed"])))
    moved = [n for n, p in trainer._model.state_dict().items()
             if not torch.equal(p.cpu(), fresh.state_dict()[n])]
    if len(moved) < 0.9 * len(fresh.state_dict()):
        fail(f"training changed only {len(moved)} of "
             f"{len(fresh.state_dict())} tensors")
    step_ms = trainer.clock.ms
    if len(step_ms) != steps:
        fail(f"{len(step_ms)} step times for {steps} steps")
    median = statistics.median(step_ms[1:])
    per_epoch = steps // EPOCHS
    epochs = [h for h in trainer.history if "train" in h]
    loop_s = [h["train_s"] for h in epochs]
    loop_rate = [h["train_volumes"] / t for h, t in zip(epochs, loop_s)]
    # wall time of the loop in which the compute stream runs no step
    outside = [1 - sum(step_ms[i * per_epoch:(i + 1) * per_epoch])
               / (1e3 * t) for i, t in enumerate(loop_s)]
    result = {"steps": steps, "step_ms": step_ms,
              "step_ms_median_after_first": median,
              "step_volumes_per_s": BATCH * 1e3 / median,
              "loop_s_per_epoch": loop_s,
              "loop_volumes_per_s_per_epoch": loop_rate,
              "loop_share_outside_steps_per_epoch": outside,
              "peak_memory_gib": peak / 2 ** 30,
              "launches_fwd_dx_dw": list(launches),
              "train_total_loss_per_epoch": train_losses,
              "val_mAP_coco": [h["metrics"]["mAP_coco"]
                               for h in trainer.history],
              "dataset_s": data_s, "run_s": run_s}
    print(f"training: foc_dec_amos 256x256x128 batch {BATCH} bf16, "
          f"{json.dumps(result)}", flush=True)
    return launches


def _entry(name, replaces, launches, rows, path_rows):
    """One kernel of the result line; times and bounds sum the path's
    shapes, one launch each."""
    return {
        "name": name, "route": "cuda",
        "source": "transoar_tpu_torch/csrc/packed_conv.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{k: sum(r[k] for r in path_rows)
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": ("operations" if any(r["bound_by"] == "operations"
                                         for r in path_rows) else "bytes"),
        "shapes": [r for r in rows if "ms" in r],
    }


def main():
    phase_device()
    phase_build()
    fwd_rows = phase_kernel()
    dx_rows, dw_rows = phase_backward()
    phase_small_model()
    phase_small_train()
    serving = phase_serving()
    training = phase_training()
    src = "transoar_tpu/ops/pallas/packed_conv.py"
    kernels = [
        _entry("packed_conv", f"{src}:166", training[0], fwd_rows,
               [r for r in fwd_rows if r.get("path") == "training"]),
        _entry("packed_conv_dx", f"{src}:233", training[1], dx_rows,
               [r for r in dx_rows if "ms" in r]),
        _entry("packed_conv_dw", f"{src}:191", training[2], dw_rows,
               [r for r in dw_rows if "ms" in r]),
    ]
    kernels[0]["launches_serving"] = serving[0]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
