"""On-card smoke test of the PyTorch/CUDA port (transoar_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the repository around it; imports no jax. Phases,
each printing a line; any failure exits non-zero before the result lines:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from csrc/, one nvcc per source, all
   started together; the registers, shared memory and spill bytes of each
   bf16 forward and dw kernel of the band conv (generic, wide and fold) and
   of the bf16 window attention kernels (generic fwd_mma / bwd_mma at d =
   16, fwd_wg / bwd_wg), and any wgmma serialisation note of ptxas (C7512,
   C7518, C7520) in the window attention's build;
3. forward kernel vs plain: packed_conv against packed_conv_reference at
   the stage-0 shapes of the four paths (foc_dec_amos and
   swin_fpn_visceral, serving batch 1 and training batch 2) and a ragged
   shape, bf16, the same bits when run twice, with the median time of each
   over 20 runs, of the generic kernel (the mma.sync kernel which the
   wide and fold kernels replaced on these shapes) at the same shapes,
   of cuDNN's bf16 conv for scale, and the card's bound for the same work;
   each row names the kernel's variant, its TFLOP/s and bound / ms;
4. backward kernels vs plain: packed_conv_dx (bf16, rtol 1.6e-2 atol
   1e-2, the same bits twice) and packed_conv_dw (f32 result, rel-L2 <=
   1e-4 against the f32 plain version of the same bf16 inputs, and
   bit-identical when run twice) at both models' training shapes and a
   ragged shape, timed as phase 3 (cuDNN's conv2d_input / conv2d_weight for
   scale; each beside its generic kernel, the mma.sync kernel which the
   wgmma kernels replaced, with its variant, TFLOP/s and bound / ms);
5. window attention kernels vs plain: fused_window_attention and its
   backward at each of swin_fpn_visceral's four Swin stages at batch 2
   (N = 125, d = 16; q, k, v as views of the qkv projection), shifted and
   unshifted, and two ragged shapes (N = 100, odd B_; d = 16 and d = 8):
   the kernel the wrapper picks (``wg`` at d = 16, ``generic`` at d = 8)
   and, for the bf16 rows, the generic kernel (the mma.sync kernel which
   the wg kernels replaced on these shapes): bf16 o, dq, dk, dv within rtol
   1.6e-2 atol 1e-2, dbias rel-L2 <= 1e-4 against the f32 plain version and
   bit-identical when run twice; the f32 variants within 1e-5, dbias
   included; timed as phase 3 (the kernel and the generic kernel), with
   SDPA (``scaled_dot_product_attention`` with the bias + mask as
   ``attn_mask``) for scale: its forward beside the forward, its backward
   alone (on a retained graph) beside the backward, and forward +
   backward of both. The picked and the generic kernel go through one
   entry (``_launch_fwd`` / ``_launch_bwd``), and every time of the phase
   is the device's: a spin kernel holds the card while the host enqueues
   the timed call, so the events do not time the host. ``call_ms`` is the
   public wrapper's time as a caller sees it, host work included. Each
   timed row prints its variant, TFLOP/s, bound / ms and ALU floor (the
   scores' exponentials over the SFU rate or their other f32 operations
   over the FP32 rate, the larger; printed only, not in the result line);
6. conv2d_3x3 (the NHWC conv on packed_conv's forward kernel) vs plain,
   the generic kernel and cuDNN on one shape;
6b. the RoI gather's backward (``ops/kernels/roi_gather.py``) at the
   flagship's and the SwinFPN's shapes (their configs' RoIs, batch 2, bf16
   rows of 384): the kernel on a contiguous gradient, as the attention's
   einsum hands it over, and on one with the heads apart (which the
   wrapper copies first), against its plain version on the CPU (the same
   bits), the same bits when run twice, one launch a call; the median
   device ms of each beside the bytes bound, the plain version's on the
   card and autograd's ``k[:, flat]`` backward (PyTorch's sorted
   ``index_put_``, with its zeros) for K and V, for scale; then one
   full-width ``FocusedAttn`` forward and backward at each shape, with the
   strides of the gradient the kernel got and whether it was copied;
7. small models, CPU vs card: tiny f32 flagship-, Swin-, seg-proxy-,
   refine-, DETR- and Deformable-DETR-shaped models (``presets``) with the
   same seeded weights on the CPU (plain versions) and on the card
   (kernels), TF32 off; logits and pred_seg within 1e-3, boxes within
   1e-4; the Swin model launches the window forward twice per Swin stage;
8. small train steps, CPU vs card: the flagship, Swin, DETR and
   Deformable-DETR tiny models at batch 2, f32, in eval() mode (no dropout
   or DropPath); loss rtol 1e-4, per-tensor gradient rel-L2 < 1e-3, the
   AdamW step's deltas within rtol 0.05 / atol 0.25 x lr; the card's step
   launches forward 4 / dx 1 / dw 2 of the band conv (remat recomputes
   stage 0) and, in the Swin model, the window forward and backward twice
   per Swin stage each;
9. serving: the full-width foc_dec_amos model (256x256x128, bf16, seeded
   random weights) saved as a run directory, then
   ``transoar_tpu_torch.predict.main`` on three synthetic NIfTI volumes off
   the training grid; 15 valid detections each, and packed_conv launched
   twice per volume;
10. prepare: ``prepare_dataset_amos.main`` on 10 synthetic AMOS-layout
   NIfTI cases off the grid (15 organs padded with air, LPS affine) into a
   temporary dataset at 256x256x128: every .npy of the grid's shape and
   dtype, finite statistics in data_info.json; if the AMOS filters keep
   all 10 cases with all 15 organs, phase 11 trains on it, else a printed
   line says why and a synthetic dataset takes its place;
11. training: ``transoar_tpu_torch.train.train`` on full-width foc_dec_amos
   at batch 2 (bf16) as shipped: host augmentation
   (``HostAugmentingLoader``, 4 threads, 4 cases in flight) over the
   native C++ loader (``trainer.num_workers: 4``); 8 train and 2 val
   cases, 2 epochs = 8 steps + 3 validations; fails unless the native
   loader served every train case and the host augmenter ran on each;
   finite losses, changed parameters, ``model_last.pt`` written, and per
   step 4 / 1 / 2 launches of the forward / dx / dw kernels; the
   step event time's median (CUDA events around each step, without the
   first; they also hold any time the card waits for the host's enqueue,
   so they are no device busy time), and per epoch the train loop's
   volumes/s over its wall time (loader, augmentation and copies
   included) and the share of that wall time outside the step events;
   the host augmentation's ms per case; peak device memory;
12. Swin serving: full-width swin_fpn_visceral (160x160x256, bf16, seeded
   random weights) through ``predict.main`` on two volumes off the grid;
   20 valid detections each, 8 window-forward and 2 packed_conv launches
   per volume, every window launch on fwd_wg;
13. Swin training: ``train.train`` on full-width swin_fpn_visceral at batch
   2, as shipped (host augmentation, native loader), over a synthetic
   160x160x256 dataset of 6 train and 2 val cases (20 organs): 2 epochs =
   6 steps + 3 validations; as phase 11, with 8 / 8 window forward /
   backward and 4 / 1 / 2 band-conv launches per step, every window launch
   on fwd_wg / bwd_wg, and peak memory under 40 GiB;
14. loop variants: each model's train loop for one epoch of 24 steps
   (a train split of links cycling through its dataset's cases) with no
   augmentation, with host augmentation as shipped (4 cases in flight),
   one batch at a time (the JAX package's design: no case in flight
   beyond the batch handed out) and on the card
   (``augmentation.on_device: true``), with the same checks and figures,
   and the steady rate after the first step and the main thread's shares
   of the loop (waiting for the loader, preparing copies, calling the
   step); each model's on-device augmentation of one batch timed alone
   (CUDA events), after one call under ``torch.cuda.set_sync_debug_mode
   ("error")``: it never waits on the host;
15. test: ``transoar_tpu_torch.test.main --val`` on the runs of phases 11
   and 13: finite mAPs in ``results_val.json``, 2 packed_conv launches a
   case (and 8 window forwards a Swin case); then the tiny f32 flagship's
   ``return_weights=True`` forward, card against CPU: attention weights
   within 1e-3; and the host augmentation alone (no training beside it)
   on 1, 4 and 8 threads over 16 cases, in cases/s;
16. families: foc_dec_seg_amos, foc_dec_refine_amos, detr_amos and
   def_detr_amos as shipped at full width (256x256x128, bf16, seeded random
   weights): ``predict.main`` on two volumes off the grid (15 detections
   each, forward and request ms, 2 packed_conv launches a volume), then
   ``train.train`` at batch 2 with host augmentation through the native
   loader for 2 epochs of 3 steps over links to the flagship dataset's
   train cases plus 3 validations: finite losses, moved parameters, per
   step 4 / 1 / 2 band-conv launches, the step event median, peak memory
   under 40 GiB on every path, and for the DETR necks the matcher's host
   ms of every call (the copy of the cost to the host, which waits for the
   forward, and the exact solve with the copy back);
17. ``test.main --val`` on phase 16's def_detr_amos run;
18. retina: retina_amos as shipped (2 epochs of 3 steps, 3 validations)
   and Retina U-Net (retina_amos with the seg proxy; 1 epoch, 2
   validations) at full width, as phase 16 trains (1,345,536 anchors,
   stage 0 on kernels 1-3), each train step's positive anchors counted
   (without any, the regression tower must not move), each validation
   decoded on the card (``retina_inference``) and the evaluator lists of
   the validation split checked (with no score threshold also against the
   NMS's contract: kept boxes in score order, none of a class overlapping
   above the IoU threshold); before them the decode on the card against
   the CPU on a seeded input without ties (1e-5);
   then the test CLI (``test.Tester`` --val, the family's serving path) on
   each run, with each case's forward and decode CUDA-event ms;
19. parallel: the flagship's train step at full width (256x256x128, batch
   2, f32 with cuDNN's default TF32 convs, eval(): no dropout) for 3
   steps from the seeded weights on 3 batches of phase 10's cases, in
   processes started with
   torchrun's environment: the plain one-process step, then (a) one rank
   over NCCL under DDP, FSDP2 and the tp code path (the neck's Megatron
   modules over a one-rank group), (b) two ranks: dp 1 + 1 and tp 2 (two
   processes sharing the card over gloo, which lacks FSDP2's
   reduce-scatter for CUDA tensors; with two cards NCCL, FSDP2 too), each
   against the plain step:
   every loss within rtol 1e-4, the first step's gradients within rel-L2
   1e-3 (phase 8's tolerances), 12 / 3 / 6 band-conv launches on every
   rank, the step event ms and peak memory of every rank; (c) ``train.main``
   under ``torch.distributed.run`` (one process a card) on foc_dec_amos as
   shipped with ``parallel.fsdp: true`` for one epoch of phase 10's
   dataset, its launches on every rank and a checkpoint in the plain
   layout, then ``test.main --val`` on it in this process;
20. sp: spatial parallelism (``parallel.sp: 2``) on foc_dec_amos and
   swin_fpn_visceral at full width (batch 2, 2 steps from the seeded
   weights on phase 10's and 13's cases, eval(): no dropout), in two
   processes (two cards over NCCL, else sharing the card over gloo), each
   holding half of the volume's first axis: f32 (cuDNN's TF32 convs)
   against the one-rank f32 step with phase 19's bounds, then bf16 with the
   first step's loss within SP_BF16_LOSS_RTOL of the one-rank bf16 step;
   every rank launching kernels 1-3 (and 4-5 on Swin) as often as one
   rank does, on the f32 kernels in f32 and the wide / fold and wg ones in
   bf16; the step event ms and peak memory of every rank beside the one
   rank's; then ``train.main`` under ``torch.distributed.run`` on each
   config as shipped with ``parallel.sp: 2`` for one epoch of its dataset
   (its launches on every rank, a checkpoint in the plain layout). Two processes sharing a card measure correctness and memory,
   not scaling;
21. bench: ``transoar_tpu_torch.bench.main`` in this process with
   ``--steps 2 --warmup 1 --scan_steps 2`` (cuDNN's default TF32, as the
   CLI runs): the flagship's train step at batch 2 and 1, its serving
   (``--mode eval``, batch 2 and 1) and swin_fpn_visceral's train step at
   batch 2; each run prints one stdout line with bench.py's keys and
   ``device``, finite values > 0, and launches kernels 1-3 (4-5 on Swin)
   as remat off gives: 2 / 1 / 2 band-conv launches a step (8 / 8 window
   forward / backward), 2 band-conv launches (8 window forwards) a volume
   served; then the flagship's bench step at batch 2 under
   ``torch.profiler``: its device busy ms (kernels, copies and memsets;
   the port's spans' device-side ranges left out), event ms and idle
   share, and the batch-2 value at most 2 / busy seconds (else the window
   missed work).

Every path is driven with all kernel counts set to 0 just before it and
read just after; every serving, training and test path also requires
every launch of the band conv's forward kernel (forward and dx), and every
training path every launch of its dw kernel, to have taken the wide or the
fold variant, never the generic one, and every launch of the window
kernels to have taken fwd_wg / bwd_wg (none on the flagship's paths).
Every train step of a model whose decoder takes the RoI path launches the
RoI gather's backward once a decoder layer (``_roi_layers``: 3 on the
focused-decoder configs, small and full width); no serving, test, eval or
dense path launches it. Phase 19's and 20's paths run in their ranks' processes, which set their
counts to 0 and report them (phase 19's f32 steps take the band conv's f32
kernels, and its ranks' variants are not read; phase 20 checks its ranks'
variants itself); ``parallel_fsdp_test`` runs here and is checked as the
other test paths.
Then a line with each model's loop rates in every augmentation setting
side by side and the host's core count, one with phase 16's and 18's configs
side by side, one JSON line of per-kernel results (each kernel's launches on
every path) and, last, the device line
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

SEED = 0
# the two packed stage-0 band convs of each path, [B*D/4, H, W, 6*C_in] ->
# 4*24 channels: foc_dec_amos at 256x256x128 and swin_fpn_visceral at
# 160x160x256; serving batch 1, training batch 2
CONV_SHAPES = {
    "serving": [((64, 256, 128, 6), 96), ((64, 256, 128, 144), 96)],
    "training": [((128, 256, 128, 6), 96), ((128, 256, 128, 144), 96)],
    "swin_serving": [((40, 160, 256, 6), 96), ((40, 160, 256, 144), 96)],
    "swin_training": [((80, 160, 256, 6), 96), ((80, 160, 256, 144), 96)],
}
TRAIN_PATHS = ("training", "swin_training")
RAGGED_SHAPE = ((3, 13, 70, 10), 40)
# request volumes off the 256x256x128 grid, so the resize runs
VOLUME_SHAPES = [(300, 280, 150), (240, 236, 110), (280, 300, 140)]
N_REQUESTS = len(VOLUME_SHAPES)
TRAIN_CASES, VAL_CASES, EPOCHS, BATCH = 8, 2, 2, 2
# epochs of the Swin training phase
SWIN_EPOCHS = 2
# each loop variant: one epoch of LOOP_STEPS steps over a train split of
# links to the dataset's train cases, so that filling the augmenter and
# the prefetch before the first step is a few per cent of the epoch (24
# since phase 20 came: the script keeps to its time)
LOOP_EPOCHS, LOOP_STEPS = 1, 24
# band conv launches per train step at batch 2 with encoder remat
STEP_LAUNCHES = {"packed_conv": 4, "packed_conv_dx": 1, "packed_conv_dw": 2}
# swin_fpn_visceral (160x160x256): per Swin stage, the windows of one volume
# after padding to 5x5x5 and the heads; N = 125, d = 16 everywhere
SWIN_STAGES = [((80, 80, 130), 3), ((40, 40, 65), 6), ((20, 20, 35), 12),
               ((10, 10, 20), 24)]
SWIN_N, SWIN_D = 125, 16
# B_, H, N, d, nW: ragged N and odd B_ at the wg kernels' d and at d = 8
RAGGED_WINDOWS = [(7, 3, 100, 16, 7), (7, 3, 100, 8, 7)]
SWIN_VOLUMES = [(170, 150, 240), (150, 172, 270)]
SWIN_TRAIN_CASES, SWIN_VAL_CASES = 6, 2
# window forward launches per Swin forward: 4 stages x 2 blocks
SWIN_WINDOW_LAUNCHES = 8
# phase 16: the shipped configs of the seg-proxy, refine, DETR and
# Deformable-DETR families at full width (256x256x128, 15 organs, as
# foc_dec_amos): two volumes served, then 2 epochs of 3 train steps; the
# test CLI on the last one's run
FAMILY_CONFIGS = ("foc_dec_seg_amos", "foc_dec_refine_amos", "detr_amos",
                  "def_detr_amos")
FAMILY_VOLUMES = VOLUME_SHAPES[:2]
FAMILY_EPOCHS, FAMILY_STEPS = 2, 3
# phase 18: retina_amos as shipped for FAMILY_EPOCHS epochs, Retina U-Net
# (retina_amos with the seg proxy) for one, each of FAMILY_STEPS steps, then
# the test CLI (the family's serving path) on each run
RETINA_RUNS = (("retina_amos", FAMILY_EPOCHS), ("retina_unet_amos", 1))
# the tiny models of phase 7 (card vs CPU forward) and those of phase 8 (a
# train step each)
SMALL_MODELS = ("flagship", "swin", "seg", "refine", "detr", "def_detr")
SMALL_TRAIN = ("flagship", "swin", "detr", "def_detr")
# the card's published dense peaks (H100 SXM data sheet, 700 W)
PEAK_BF16_FLOPS, PEAK_BYTES_S = 989e12, 3.35e12
# its f32 rate outside the tensor cores: 67 TFLOP/s counts an FMA as two,
# so 33.5e12 operations/s on the 128 FP32 lanes of each SM; the 16 SFU
# lanes of each SM give an eighth of that in exponentials
PEAK_F32_OPS = 67e12 / 2
PEAK_SFU = PEAK_F32_OPS / 8
# f32 operations per score besides its exponential, as the wg kernels do
# them: forward 6 (bias add, mask compare, mask add, row max, the exponent's
# FMA, row sum); backward 15 (those 6, the normalisation, the P o dP row
# sum, dS's subtract and multiply, the dbias add, P's bf16 rounding (half
# an instruction a score) and dS's hi / lo split: hi's rounding (a half),
# widening hi, the subtraction, lo's rounding (a half))
SCORE_OPS = {False: 6, True: 15}
# the spin ahead of a held timing: ~1 ms at the H100's 1.98 GHz, more than
# the host takes to enqueue any timed call of the window phase
HOLD_CYCLES = 2_000_000


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _kernels():
    from transoar_tpu_torch.ops.kernels import packed_conv as pc

    return pc


def _wrappers():
    from transoar_tpu_torch.ops.kernels import (conv2d, roi_gather,
                                                window_attention)

    pc = _kernels()
    return {"packed_conv": pc.packed_conv,
            "packed_conv_dx": pc.packed_conv_dx,
            "packed_conv_dw": pc.packed_conv_dw,
            "fused_window_attention": window_attention.fused_window_attention,
            "fused_window_attention_bwd":
                window_attention.fused_window_attention_bwd,
            "conv2d_3x3": conv2d.conv2d_3x3,
            "roi_gather_bwd": roi_gather.roi_gather_bwd}


def _counts():
    """Every kernel's launch count, by wrapper name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def _reset_launches():
    from transoar_tpu_torch.ops.kernels import window_attention as wa

    for fn in _wrappers().values():
        fn.launches = 0
    pc = _kernels()
    for variants in (pc.variant_launches, pc.dw_variant_launches,
                     wa.variant_launches, wa.bwd_variant_launches):
        for v in variants:
            variants[v] = 0


# the band conv's forward and dw kernel launches by variant, and the window
# attention's forward and backward ones, per main path
VARIANTS_BY_PATH, DW_VARIANTS_BY_PATH = {}, {}
WINDOW_VARIANTS_BY_PATH, WINDOW_BWD_VARIANTS_BY_PATH = {}, {}


def _check_window_variants(path, counts):
    """Every window attention launch of the path took the wg kernels (the
    flagship's paths launch none); keeps the counts in
    WINDOW_(BWD_)VARIANTS_BY_PATH."""
    from transoar_tpu_torch.ops.kernels import window_attention as wa

    for table, launched, by_path, variants in (
            ("forward", counts["fused_window_attention"],
             WINDOW_VARIANTS_BY_PATH, wa.variant_launches),
            ("backward", counts["fused_window_attention_bwd"],
             WINDOW_BWD_VARIANTS_BY_PATH, wa.bwd_variant_launches)):
        got = {k: v for k, v in variants.items() if v}
        want = {"wg": launched} if launched else {}
        if got != want:
            fail(f"{path}: window attention {table} kernel variants {got}, "
                 f"want {want}")
        by_path[path] = got


def _check_variants(path, counts):
    """The band conv's forward kernel ran as fold for each first conv (Cin
    = 6) and as wide for each second conv and each dx, its dw kernel as
    fold for each first conv's dw and as wide for each second's, and never
    as the generic kernel; keeps the counts in (DW_)VARIANTS_BY_PATH."""
    pc = _kernels()
    for table, launched, by_path, extra in (
            ("forward", counts["packed_conv"], VARIANTS_BY_PATH,
             counts["packed_conv_dx"]),
            ("dw", counts["packed_conv_dw"], DW_VARIANTS_BY_PATH, 0)):
        variants = (pc.variant_launches if table == "forward"
                    else pc.dw_variant_launches)
        got = {k: v for k, v in variants.items() if v}
        n = launched // 2
        want = {k: v for k, v in (("fold", n), ("wide", n + extra)) if v}
        if got != want:
            fail(f"{path}: band conv {table} kernel variants {got}, "
                 f"want {want}")
        by_path[path] = got


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
    from transoar_tpu_torch.ops.kernels import window_attention as wa
    from transoar_tpu_torch.ops.kernels._build import build_log, load_library

    names = ("packed_conv", "window_attention", "roi_gather")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # nvcc runs in parallel
        list(pool.map(load_library, names))
    secs = time.perf_counter() - t0
    for name in names:
        ptxas = [line.strip() for line in build_log(name).splitlines()
                 if "registers" in line or "spill" in line]
        print(f"build: {name}.cu " + " | ".join(ptxas), flush=True)
    print(f"build: {len(names)} sources in {secs:.2f} s", flush=True)
    pc = _kernels()
    cases = (("generic", 96), ("wide", 64), ("wide", 96), ("wide", 144),
             ("fold", 96))
    for dw in (False, True):
        attrs = {f"{v}<{c}>": pc.kernel_attrs(v, c, dw=dw) for v, c in cases}
        print(f"build: band conv {'dw' if dw else 'forward'} kernels "
              f"(registers, shared memory, spill bytes per thread; the wide "
              f"dw kernel's ring at Cin 144) {json.dumps(attrs)}", flush=True)
    attrs = {n: wa.kernel_attrs(n)
             for n in ("fwd_mma", "bwd_mma", "fwd_wg", "bwd_wg")}
    serial = [line.strip() for line in build_log("window_attention")
              .splitlines() if any(c in line for c in ("C7512", "C7518",
                                                       "C7520"))]
    print(f"build: window attention bf16 kernels (registers, shared memory, "
          f"spill bytes per thread) {json.dumps(attrs)}; wgmma "
          f"serialisation notes {serial}", flush=True)


def _median_ms(fn, runs=20, warmup=3, hold=False):
    """Median event time of ``fn`` in ms. With ``hold`` a spin kernel of
    HOLD_CYCLES runs ahead of the start event, so the host's enqueue of
    ``fn`` overlaps it and the events time the device's work alone."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
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


def _rates(row, flops):
    """Adds the achieved TFLOP/s and bound / ms to a timed ``row``."""
    row["tflops"] = flops / row["ms"] / 1e9
    row["bound_share"] = row["bound_ms"] / row["ms"]


def _timed_conv(row, flops, ours, generic):
    """Adds the kernel's and the generic kernel's median ms, the achieved
    TFLOP/s and bound / ms to ``row``."""
    row["ms"] = _median_ms(ours)
    row["generic_ms"] = _median_ms(generic)
    _rates(row, flops)


def _same_bits(name, fn, first):
    if not torch.equal(fn(), first):
        fail(f"{name} differs from itself on a rerun")


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
    cases = [(path, s) for path, shapes in CONV_SHAPES.items()
             for s in shapes] + [(None, RAGGED_SHAPE)]
    for path, (shape, cout) in cases:
        cin = shape[-1]
        xh, wp = _inputs(gen, shape, cout)
        ours = pc.packed_conv(xh, wp)
        ref = pc.packed_conv_reference(xh, wp)
        torch.cuda.synchronize()
        torch.testing.assert_close(ours, ref, rtol=1.6e-2, atol=1e-2)
        _same_bits(f"packed_conv at {shape}x{cout}",
                   lambda: pc.packed_conv(xh, wp), ours)
        row = {"shape": list(shape), "cout": cout,
               "variant": pc._variant(xh, wp),
               "max_abs_err": (ours.float() - ref.float()).abs().max().item()}
        del ours, ref
        if path is not None:
            flops, pixels = _conv_work(shape, cin, cout)
            row["bound_ms"], row["bound_by"] = _bound(
                flops, 2 * pixels * (cin + cout) + 2 * wp.numel())
            x_nchw = xh.permute(0, 3, 1, 2)  # channels-last view
            w_oihw = wp.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            _timed_conv(row, flops, lambda: pc.packed_conv(xh, wp),
                        lambda: pc._launch_conv(xh, wp, "generic"))
            row["plain_ms"] = _median_ms(
                lambda: pc.packed_conv_reference(xh, wp))
            row["library_ms"] = _median_ms(
                lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1))
            row["path"] = path
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
    cases = [(path, s) for path in TRAIN_PATHS
             for s in CONV_SHAPES[path]] + [(None, RAGGED_SHAPE)]
    for path, (shape, cout) in cases:
        cin = shape[-1]
        timed = path is not None
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
            _same_bits(f"packed_conv_dx at {list(dy.shape)}x{cin}",
                       lambda: pc.packed_conv_dx(dy, wp), dx)
            wflip = wp.flip(0, 1).transpose(2, 3).contiguous()
            row = {"shape": list(dy.shape), "cout": cin,
                   "variant": pc._variant(dy, wflip),
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
                # the generic kernel behind the same flip as the wrapper's
                _timed_conv(row, flops, lambda: pc.packed_conv_dx(dy, wp),
                            lambda: pc._launch_conv(
                                dy, wp.flip(0, 1).transpose(2, 3)
                                .contiguous(), "generic"))
                row["plain_ms"] = _median_ms(
                    lambda: pc.packed_conv_dx_reference(dy, wp))
                row["library_ms"] = _median_ms(
                    lambda: torch.nn.grad.conv2d_input(
                        in_shape, w_oihw, dy_nchw, padding=1))
                row["path"] = path
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
        row = {"shape": list(shape), "cout": cout,
               "variant": pc._dw_variant(xh, dy), "rel_l2": rel,
               "max_abs_err": (dw - ref).abs().max().item(),
               "bit_identical_rerun": True}
        del dw, again, ref
        if timed:
            row["bound_ms"], row["bound_by"] = _bound(
                flops, 2 * pixels * (cin + cout) + 4 * 9 * cin * cout)
            x_nchw = xh.permute(0, 3, 1, 2)
            dy_nchw = dy.permute(0, 3, 1, 2)
            _timed_conv(row, flops, lambda: pc.packed_conv_dw(xh, dy),
                        lambda: pc._launch_dw(xh, dy, "generic"))
            row["plain_ms"] = _median_ms(
                lambda: pc.packed_conv_dw_reference(xh, dy))
            row["library_ms"] = _median_ms(
                lambda: torch.nn.grad.conv2d_weight(
                    x_nchw, (cout, cin, 3, 3), dy_nchw, padding=1))
            row["path"] = path
        dw_rows.append(row)
        print(f"backward: packed_conv_dw {json.dumps(row)}", flush=True)
        del xh, wp, dy
        torch.cuda.empty_cache()
    return dx_rows, dw_rows


def _window_inputs(gen, B, H, N, d, region, dtype=torch.bfloat16):
    """q, k, v as views of one [B_, N, 3, H, d] projection (q scaled by
    d^-0.5), a N(0, 1) bias, and an output gradient in [B_, N, H, d] memory,
    as the Swin module hands them to the kernels."""
    qkv = torch.randn((B, N, 3, H, d), generator=gen, device="cuda")
    qkv[:, :, 0] *= d ** -0.5
    qkv = qkv.to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bias = torch.randn((H, N, N), generator=gen, device="cuda")
    do = torch.randn((B, N, H, d), generator=gen, device="cuda").to(dtype)
    return q, k, v, bias, region, do.transpose(1, 2)


def _alu_floor(B, H, N, backward):
    """ms of the scores' elementwise work at the card's peaks: their
    exponentials over the SFU rate or their other f32 operations
    (SCORE_OPS) over the FP32 rate, whichever is larger (the two units run
    side by side)."""
    scores = B * H * N * N
    return 1e3 * max(scores / PEAK_SFU,
                     SCORE_OPS[backward] * scores / PEAK_F32_OPS)


def _window_work(B, H, N, d, nW, backward, itemsize=2):
    """(flops, bytes) of the forward (2 products) or the backward (5), each
    input read once and each output written once."""
    heads = B * H * N * d * itemsize
    consts = 4 * H * N * N + 4 * nW * N
    if backward:
        return 10 * B * H * N * N * d, 7 * heads + consts + 4 * H * N * N
    return 4 * B * H * N * N * d, 4 * heads + consts


def _sdpa_args(q, k, v, bias, region):
    """SDPA's operands for the same function: the bias plus the -100 mask
    as one bf16 ``attn_mask`` [B_ or 1, H, N, N], built once."""
    nW = region.shape[0]
    mask = torch.where(region[:, None, :, None] != region[:, None, None, :],
                       -100.0, 0.0) + bias[None]
    if nW > 1:
        mask = mask.repeat(q.shape[0] // nW, 1, 1, 1)
    return q, k, v, mask.to(q.dtype)


def _check_window_case(wa, q, k, v, bias, region, do, tol, dbias_tol,
                       label):
    """Forward and backward against the plain versions, o, dq, dk and dv
    within ``tol`` = (rtol, atol), dbias within rel-L2 ``dbias_tol`` and the
    same bits on a rerun: the kernels the wrappers pick and, for bf16, the
    generic kernels. Returns the picked kernels' two max abs errors and
    dbias's rel-L2."""
    rtol, atol = tol
    kernels = [("", wa.fused_window_attention,
                wa.fused_window_attention_bwd)]
    if q.dtype == torch.bfloat16 and wa._window_variant(q) != "generic":
        kernels.append((" generic",
                        lambda *a: wa._launch_fwd(*a, "generic"),
                        lambda *a: wa._launch_bwd(*a, "generic")))
    ref = wa.window_attention_reference(q, k, v, bias, region)
    bref = wa.window_attention_bwd_reference(q, k, v, bias, region, do)
    errs = []
    for name, fwd, bwd in kernels:
        o = fwd(q, k, v, bias, region)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            o, ref, rtol=rtol, atol=atol,
            msg=lambda m, n=name: f"{label}{n} forward: {m}")
        fwd_err = (o.float() - ref.float()).abs().max().item()
        del o
        grads = bwd(q, k, v, bias, region, do)
        again = bwd(q, k, v, bias, region, do)
        torch.cuda.synchronize()
        for gname, a, b in zip(("dq", "dk", "dv"), grads[:3], bref[:3]):
            torch.testing.assert_close(
                a, b, rtol=rtol, atol=atol,
                msg=lambda m, n=f"{name} {gname}": f"{label}{n}: {m}")
        rel = _rel_l2(grads[3], bref[3])
        if rel > dbias_tol:
            fail(f"window attention {label}{name} dbias: rel-L2 {rel:.2e}")
        if not torch.equal(grads[3], again[3]):
            fail(f"window attention {label}{name}: dbias is not "
                 f"deterministic")
        bwd_err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(grads, bref))
        errs.append((fwd_err, bwd_err, rel))
        del grads, again
    return errs[0]


def phase_window_kernels():
    from transoar_tpu_torch.models.swin import _regions
    from transoar_tpu_torch.ops.kernels import window_attention as wa

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    fwd_rows, bwd_rows = [], []
    N, d = SWIN_N, SWIN_D
    for stage, (padded, H) in enumerate(SWIN_STAGES, start=2):
        for shifted in (False, True):
            region = _regions(padded, (5, 5, 5),
                              (2, 2, 2) if shifted else (0, 0, 0),
                              torch.device("cuda"))
            nW = int(np.prod(padded)) // N
            B = BATCH * nW
            q, k, v, bias, region, do = _window_inputs(gen, B, H, N, d,
                                                       region)
            label = f"stage {stage} {'shifted' if shifted else 'unshifted'}"
            fwd_err, bwd_err, rel = _check_window_case(
                wa, q, k, v, bias, region, do, (1.6e-2, 1e-2), 1e-4, label)
            base = {"stage": stage, "shifted": shifted,
                    "shape": [B, H, N, d], "region_rows": region.shape[0]}
            sq, sk, sv, mask = _sdpa_args(q, k, v, bias, region)
            leaves = [t.detach().requires_grad_() for t in (sq, sk, sv)]
            # SDPA's backward alone, on one retained forward graph
            sdpa_out = F.scaled_dot_product_attention(
                *leaves, attn_mask=mask, scale=1.0)

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(
                    *leaves, attn_mask=mask, scale=1.0)
                torch.autograd.grad(out, leaves, do)

            def kernels_fwd_bwd():
                wa.fused_window_attention(q, k, v, bias, region)
                wa.fused_window_attention_bwd(q, k, v, bias, region, do)

            row = dict(base, variant=wa._window_variant(q),
                       max_abs_err=fwd_err)
            work = _window_work(B, H, N, d, region.shape[0], False)
            row["bound_ms"], row["bound_by"] = _bound(*work)
            row["ms"] = _median_ms(
                lambda: wa._launch_fwd(q, k, v, bias, region), hold=True)
            row["generic_ms"] = _median_ms(
                lambda: wa._launch_fwd(q, k, v, bias, region, "generic"),
                hold=True)
            row["call_ms"] = _median_ms(
                lambda: wa.fused_window_attention(q, k, v, bias, region))
            _rates(row, work[0])
            row["plain_ms"] = _median_ms(
                lambda: wa.window_attention_reference(q, k, v, bias, region),
                hold=True)
            row["library_ms"] = _median_ms(
                lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, attn_mask=mask, scale=1.0), hold=True)
            fwd_rows.append(row)
            shown = dict(row, alu_floor_ms=_alu_floor(B, H, N, False))
            print(f"window kernel: fused_window_attention "
                  f"{json.dumps(shown)}", flush=True)
            row = dict(base, variant=wa._window_variant(q),
                       max_abs_err=bwd_err, dbias_rel_l2=rel,
                       dbias_bit_identical_rerun=True)
            work = _window_work(B, H, N, d, region.shape[0], True)
            row["bound_ms"], row["bound_by"] = _bound(*work)
            row["ms"] = _median_ms(lambda: wa._launch_bwd(
                q, k, v, bias, region, do), hold=True)
            row["generic_ms"] = _median_ms(lambda: wa._launch_bwd(
                q, k, v, bias, region, do, "generic"), hold=True)
            row["call_ms"] = _median_ms(lambda: wa.fused_window_attention_bwd(
                q, k, v, bias, region, do))
            _rates(row, work[0])
            row["plain_ms"] = _median_ms(
                lambda: wa.window_attention_bwd_reference(
                    q, k, v, bias, region, do), hold=True)
            row["library_ms"] = _median_ms(lambda: torch.autograd.grad(
                sdpa_out, leaves, do, retain_graph=True), hold=True)
            row["fwd_bwd_ms"] = _median_ms(kernels_fwd_bwd, hold=True)
            row["library_fwd_bwd_ms"] = _median_ms(sdpa_fwd_bwd, hold=True)
            bwd_rows.append(row)
            shown = dict(row, alu_floor_ms=_alu_floor(B, H, N, True))
            print(f"window kernel: fused_window_attention_bwd "
                  f"{json.dumps(shown)}", flush=True)
            del q, k, v, do, sq, sk, sv, mask, leaves, sdpa_out
            torch.cuda.empty_cache()

    ragged = []
    for B, H, N, d, nW in RAGGED_WINDOWS:
        region = torch.randint(0, 4, (nW, N), generator=gen,
                               device="cuda").float()
        inputs = _window_inputs(gen, B, H, N, d, region)
        errs = _check_window_case(wa, *inputs, (1.6e-2, 1e-2), 1e-4,
                                  f"ragged d = {d}")
        variant = wa._window_variant(inputs[0])
        fwd_rows.append({"shape": [B, H, N, d], "variant": variant,
                         "max_abs_err": errs[0]})
        bwd_rows.append({"shape": [B, H, N, d], "variant": variant,
                         "max_abs_err": errs[1], "dbias_rel_l2": errs[2]})
        ragged.append(f"{[B, H, N, d]} ({variant}) forward {errs[0]:.3g} "
                      f"backward {errs[1]:.3g}")
    # the f32 variants (CUDA cores) at stage 4's shifted windows, batch 2
    padded, H = SWIN_STAGES[2]
    region = _regions(padded, (5, 5, 5), (2, 2, 2), torch.device("cuda"))
    f32 = _check_window_case(
        wa, *_window_inputs(gen, BATCH * region.shape[0], H, SWIN_N, SWIN_D,
                            region, torch.float32), (1e-5, 1e-5), 1e-5,
        "f32")
    print(f"window kernel: ragged bf16 max abs err {'; '.join(ragged)}; f32 "
          f"variants at stage 4 max abs err forward {f32[0]:.3g} backward "
          f"{f32[1]:.3g}, dbias rel-L2 {f32[2]:.2e}", flush=True)
    return fwd_rows, bwd_rows


def phase_conv2d():
    from transoar_tpu_torch.ops.kernels.conv2d import (conv2d_3x3,
                                                       conv2d_3x3_reference)

    pc = _kernels()

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n, h, w, c, f = 8, 128, 128, 64, 64
    x = torch.randn((n, h, w, c), generator=gen, device="cuda").bfloat16()
    wt = torch.randn((3, 3, c, f), generator=gen, device="cuda")
    wt /= (9 * c) ** 0.5
    ours = conv2d_3x3(x, wt)
    ref = conv2d_3x3_reference(x, wt)
    torch.cuda.synchronize()
    torch.testing.assert_close(ours, ref, rtol=1.6e-2, atol=1e-2)
    _same_bits("conv2d_3x3", lambda: conv2d_3x3(x, wt), ours)
    row = {"shape": [n, h, w, c], "cout": f,
           "variant": pc._variant(x, wt.bfloat16()),
           "max_abs_err": (ours.float() - ref.float()).abs().max().item()}
    flops = 2 * n * h * w * 9 * c * f
    row["bound_ms"], row["bound_by"] = _bound(
        flops, 2 * n * h * w * (c + f) + 4 * wt.numel())
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = wt.bfloat16().permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    # the generic kernel behind the same cast as the wrapper's
    _timed_conv(row, flops, lambda: conv2d_3x3(x, wt),
                lambda: pc._launch_conv(x, wt.bfloat16(), "generic"))
    row["plain_ms"] = _median_ms(lambda: conv2d_3x3_reference(x, wt))
    row["library_ms"] = _median_ms(
        lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1))
    print(f"conv2d_3x3: {json.dumps(row)}", flush=True)
    return [row]


def _roi_inputs(name):
    """(idx, valid, S) of the config's RoI at its input level."""
    from transoar_tpu_torch.models import focused_decoder as fd
    from transoar_tpu_torch.presets import model_config

    cfg = model_config(name)
    shape = fd.level_spatial_shape(cfg["augmentation"]["patch_size"],
                                   int(cfg["neck"]["input_levels"][-1]))
    bias = fd.generate_attn_bias(cfg["bbox_properties"], shape)
    idx, valid = fd.roi_token_indices(bias)
    return idx, valid, bias.shape[1]


def phase_roi_gather():
    from transoar_tpu_torch.models import focused_decoder as fd
    from transoar_tpu_torch.ops.kernels import roi_gather as rg

    rows = []
    B, H, hd = BATCH, 8, 48
    for name in ("foc_dec_amos", "swin_fpn_visceral"):
        idx, valid, S = _roi_inputs(name)
        offsets, slots = fd.roi_inverse_index(
            torch.as_tensor(idx).long(), torch.as_tensor(valid), S)
        offsets, slots = offsets.cuda(), slots[:int(offsets[-1])].cuda()
        nnz, N = slots.numel(), idx.size
        flat = torch.as_tensor(idx).reshape(-1).cuda()
        live = torch.as_tensor(valid).reshape(-1).cuda()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
        # [B, N, H, hd] with the heads apart, as the einsum's backward
        # gives it, zero on the pads, as the softmax does
        grads = [(torch.randn((B, H, N, hd), generator=gen, device="cuda")
                  * live[None, None, :, None]).bfloat16().transpose(1, 2)
                 for _ in range(2)]
        dense = [g.contiguous() for g in grads]
        ref = rg.roi_gather_bwd_reference(*(g.cpu() for g in grads),
                                          offsets.cpu(), slots.cpu(), S)
        row = {"config": name, "B": B, "S": S, "slots": N, "valid": nnz,
               "width": H * hd}
        for layout, g in (("contiguous", dense), ("heads_apart", grads)):
            before = rg.roi_gather_bwd.launches
            ours = rg.roi_gather_bwd(*g, offsets, slots, S)
            torch.cuda.synchronize()
            if rg.roi_gather_bwd.launches != before + 1:
                fail(f"roi_gather_bwd {name}: launches "
                     f"{rg.roi_gather_bwd.launches - before}, want 1")
            for got, want in zip(ours, ref):
                if not torch.equal(got.cpu(), want):
                    fail(f"roi_gather_bwd {name} ({layout}) differs from "
                         f"its plain version")
            again = rg.roi_gather_bwd(*g, offsets, slots, S)
            if not all(torch.equal(a, b) for a, b in zip(again, ours)):
                fail(f"roi_gather_bwd {name} ({layout}) differs from itself "
                     f"on a rerun")
            row["ms" if layout == "contiguous" else "copy_ms"] = \
                _median_ms(lambda: rg.roi_gather_bwd(*g, offsets, slots, S),
                           hold=True)
        row["max_abs_err"] = 0.0
        nbytes = 2 * 2 * B * (nnz + S) * H * hd + 4 * (S + 1 + nnz)
        row["bound_ms"], row["bound_by"] = _bound(0, nbytes)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["plain_ms"] = _median_ms(lambda: rg.roi_gather_bwd_reference(
            *grads, offsets, slots, S), hold=True)
        kh = [torch.zeros((B, S, H, hd), dtype=torch.bfloat16,
                          device="cuda", requires_grad=True)
              for _ in range(2)]
        gathered = [k[:, flat] for k in kh]
        row["indexing_ms"] = _median_ms(lambda: torch.autograd.grad(
            gathered, kh, grads, retain_graph=True), hold=True)
        row["attn_layer"] = _roi_attention_layer(name, idx, valid, S)
        print(f"roi_gather_bwd: {json.dumps(row)}", flush=True)
        rows.append(row)
    return rows


def _roi_attention_layer(name, idx, valid, S):
    """One full-width bf16 FocusedAttn forward and backward on the RoI
    path: its launches and the gradient's layout as the kernel got it."""
    from transoar_tpu_torch.models import focused_decoder as fd
    from transoar_tpu_torch.ops.kernels import roi_gather as rg

    organs, C, qpo = idx.shape[0], 384, 27
    attn = fd.FocusedAttn(C, 8, organs).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for layer in (attn.k_proj, attn.v_proj, attn.proj):
        layer.reset_parameters(gen)
    q = torch.randn((BATCH, organs * qpo, C), generator=gen, device="cuda")
    k = torch.randn((BATCH, S, C), generator=gen, device="cuda")
    q, k = q.bfloat16(), k.bfloat16().requires_grad_()
    roi = [torch.as_tensor(a).cuda() for a in (idx, valid)]
    roi[0] = roi[0].long()
    roi += list(fd.roi_inverse_index(*roi, S))
    seen, operand = [], rg._operand

    def spy(g):
        out = operand(g)
        seen.append({"shape": list(g.shape), "strides": list(g.stride()),
                     "copied": out.data_ptr() != g.data_ptr()})
        return out

    before = rg.roi_gather_bwd.launches
    rg._operand = spy
    try:
        out = attn(q, k, k, torch.zeros(organs, S, device="cuda"),
                   tuple(roi))
        out.float().square().sum().backward()
        torch.cuda.synchronize()
    finally:
        rg._operand = operand
    launches = rg.roi_gather_bwd.launches - before
    if launches != 1 or not torch.isfinite(k.grad).all():
        fail(f"FocusedAttn {name}: {launches} roi_gather_bwd launches, "
             f"finite gradient {bool(torch.isfinite(k.grad).all())}")
    return {"launches": launches, "gradients": seen}


def _tiny(kind):
    from transoar_tpu_torch.presets import (tiny_config,
                                            tiny_flagship_config,
                                            tiny_swin_config)

    cfg = (tiny_swin_config() if kind == "swin" else tiny_flagship_config()
           if kind == "flagship" else tiny_config(kind))
    assert cfg["backbone"]["stage0_pack"] == 4
    swin = cfg["backbone"]["swin"]["depths"] \
        if cfg["backbone"].get("use_encoder_attn") else []
    return cfg, sum(swin)


def phase_small_model(kind):
    from transoar_tpu_torch.models.transoarnet import build_model
    from transoar_tpu_torch.utils.weights import random_state_dict

    cfg, windows = _tiny(kind)
    outs = {}
    for device in ("cpu", "cuda"):
        model = build_model(cfg, dtype=torch.float32, device=device).eval()
        model.load_state_dict(random_state_dict(model, SEED))
        x = np.random.default_rng(SEED).normal(
            size=(1, *cfg["augmentation"]["patch_size"], 1))
        before = _counts()
        with torch.inference_mode():
            out = model(torch.as_tensor(x, dtype=torch.float32,
                                        device=device))
        torch.cuda.synchronize()
        after = _counts()
        launched = (after["packed_conv"] - before["packed_conv"],
                    after["fused_window_attention"]
                    - before["fused_window_attention"])
        want = (2, windows) if device == "cuda" else (0, 0)
        if launched != want:
            fail(f"small {kind} model on {device}: packed_conv / window "
                 f"launches {launched}, want {want}")
        outs[device] = {k: v.cpu() for k, v in out.items()}
    errs = {}
    if set(outs["cuda"]) != set(outs["cpu"]):
        fail(f"small {kind} model outputs {sorted(outs['cuda'])} on the "
             f"card, {sorted(outs['cpu'])} on the CPU")
    for key in outs["cpu"]:
        tol = 1e-4 if key.endswith("boxes") else 1e-3  # logits, pred_seg
        torch.testing.assert_close(outs["cuda"][key], outs["cpu"][key],
                                   rtol=0, atol=tol)
        errs[key] = (outs["cuda"][key] - outs["cpu"][key]).abs().max().item()
    print(f"small {kind} model: card vs CPU max abs diff {json.dumps(errs)}; "
          f"card launches packed_conv / window {launched}", flush=True)


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
    counts = _counts()
    losses = step({k: torch.as_tensor(v, device=device)
                   for k, v in batch.items()})
    torch.cuda.synchronize()
    after = _counts()
    launched = {k: after[k] - counts[k] for k in after if after[k] > counts[k]}
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    after = {n: p.detach().cpu() for n, p in model.named_parameters()}
    return float(losses["total"]), grads, before, after, launched


def phase_small_train(kind):
    from transoar_tpu_torch.data.synthetic import make_case

    cfg, windows = _tiny(kind)
    cfg["trainer"]["precision"] = "float32"
    cfg["augmentation"]["use_augmentation"] = False
    rng = np.random.default_rng(SEED)
    cases = [make_case(rng, cfg["augmentation"]["patch_size"],
                       cfg["bbox_properties"]) for _ in range(BATCH)]
    batch = {"image": np.stack([c[0] for c in cases])[..., None],
             "seg": np.stack([c[1] for c in cases])}
    cpu = _small_train_step(cfg, "cpu", batch)
    card = _small_train_step(cfg, "cuda", batch)
    want = dict(STEP_LAUNCHES)
    if windows:
        want.update(fused_window_attention=windows,
                    fused_window_attention_bwd=windows)
    if _roi_layers(cfg):
        want["roi_gather_bwd"] = _roi_layers(cfg)
    if cpu[4] or card[4] != want:
        fail(f"small {kind} train step launches: CPU {cpu[4]}, card "
             f"{card[4]}, want none and {want}")
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    if loss_rel > 1e-4:
        fail(f"small {kind} train step loss: card {card[0]} vs CPU {cpu[0]}")
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
            fail(f"small {kind} train step gradient {name}: rel-L2 "
                 f"{rel:.2e}")
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
    print(f"small {kind} train step: card vs CPU loss rel {loss_rel:.2e}, "
          f"worst gradient rel-L2 {worst:.2e} over "
          f"{len(cpu[1]) - len(negligible)} tensors, AdamW deltas within "
          f"tolerance; card launches {json.dumps(card[4])}", flush=True)


def _serve(cfg, name, volumes):
    """Save a seeded random run of ``cfg`` and serve ``volumes`` through
    predict.main with every count at 0 before; returns the records, the
    counts and the peak memory."""
    from transoar_tpu_torch import predict
    from transoar_tpu_torch.presets import save_random_run, write_ct_volumes

    cfg["foreground_voxel_statistics"] = {"percentile_00_5": -1000.0,
                                          "percentile_99_5": 1000.0}
    with tempfile.TemporaryDirectory() as tmp:
        save_random_run(cfg, Path(tmp) / "runs" / name, SEED)
        inputs = write_ct_volumes(tmp, volumes, SEED)

        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            records = predict.main(["--run", name, "--input", *inputs])
            counts = _counts()
        finally:
            os.chdir(cwd)
    peak = torch.cuda.max_memory_allocated()

    organs = cfg["neck"]["num_organs"]
    if len(records) != len(volumes):
        fail(f"{name} serving answered {len(records)} of {len(volumes)}")
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
    return records, counts, peak


def _serving_line(name, cfg, records, peak, counts):
    fwd = [1e3 * r["forward_s"] for r in records]
    tot = [1e3 * r["total_s"] for r in records]
    grid = "x".join(map(str, cfg["augmentation"]["patch_size"]))
    print(f"{name}: {len(records)} requests at {grid}, "
          f"{cfg['neck']['num_organs']} detections each; forward ms {fwd} "
          f"(median {statistics.median(fwd):.1f}); end to end ms {tot} "
          f"(median {statistics.median(tot):.1f}); peak device memory "
          f"{peak / 2**30:.2f} GiB; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}",
          flush=True)


def phase_serving():
    from transoar_tpu_torch.presets import flagship_config

    cfg = flagship_config()
    records, counts, peak = _serve(cfg, "foc_dec_amos", VOLUME_SHAPES)
    want = {"packed_conv": 2 * N_REQUESTS}
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        fail(f"serving launched {got}, want {want}")
    _check_variants("serving", counts)
    _check_window_variants("serving", counts)
    _serving_line("serving", cfg, records, peak, counts)
    return counts


def phase_swin_serving():
    from transoar_tpu_torch.presets import swin_fpn_config

    cfg = swin_fpn_config()
    records, counts, peak = _serve(cfg, "swin_fpn_visceral", SWIN_VOLUMES)
    n = len(SWIN_VOLUMES)
    want = {"packed_conv": 2 * n,
            "fused_window_attention": SWIN_WINDOW_LAUNCHES * n}
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        fail(f"Swin serving launched {got}, want {want}")
    _check_variants("swin_serving", counts)
    _check_window_variants("swin_serving", counts)
    _serving_line("swin serving", cfg, records, peak, counts)
    return counts


def _dataset(root, cfg, train_cases, val_cases):
    """A synthetic dataset of cfg's grid and organs under root/dataset;
    returns (its name, the seconds it took)."""
    from transoar_tpu_torch.data.synthetic import generate_dataset

    name = f"synthetic_{cfg['neck']['num_organs']}"
    t0 = time.perf_counter()
    generate_dataset(Path(root) / "dataset", name=name,
                     shape=tuple(cfg["augmentation"]["patch_size"]),
                     num_classes=cfg["neck"]["num_organs"],
                     num_train=train_cases, num_val=val_cases, num_test=0,
                     seed=SEED)
    return name, time.perf_counter() - t0


def _train(cfg, name, root, dataset, epochs, debug=False, still=None,
           **trainer_options):
    """train.train on root/dataset/<dataset> in root, with every count at 0
    before; checks losses, moved parameters, the step count and (unless
    ``debug``: no checkpoints, no validation after the epochs)
    model_last.pt; returns (trainer, counts, peak, run_s). ``still()``,
    asked after the run, names the parameter prefixes that had no
    gradient in it: those must not have moved, and at least 90% of the
    others must have."""
    from transoar_tpu_torch import train
    from transoar_tpu_torch.models.transoarnet import build_model
    from transoar_tpu_torch.utils.io import load_json

    cfg.update(experiment_name=name, dataset=dataset, debug_mode=debug)
    cfg.update(load_json(Path(root) / "dataset" / dataset / "data_info.json"))
    cfg["trainer"].update(epochs=epochs,
                          val_interval=epochs + 1 if debug else 1)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        trainer = train.train(cfg, SimpleNamespace(
            device="cuda", data_dir=str(Path(root) / "dataset"),
            resume=None, auto_resume=False), **trainer_options)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        os.chdir(cwd)
    if not debug and not (Path(root) / "runs" / name / "model_last.pt") \
            .exists():
        fail(f"{name} training wrote no model_last.pt")

    train_losses = [h["train"]["total"] for h in trainer.history
                    if "train" in h]
    if len(train_losses) != epochs or not np.isfinite(train_losses).all():
        fail(f"{name} training losses {train_losses}")
    fresh = build_model(cfg, device="cpu", generator=torch.Generator()
                        .manual_seed(int(cfg["seed"])))
    moved = [n for n, p in trainer._model.state_dict().items()
             if not torch.equal(p.cpu(), fresh.state_dict()[n])]
    prefixes = tuple(still()) if still else ()
    frozen = [n for n in fresh.state_dict() if n.startswith(prefixes)]
    if set(frozen) & set(moved):
        fail(f"{name} training moved {sorted(set(frozen) & set(moved))} "
             f"without a gradient")
    if len(moved) < 0.9 * (len(fresh.state_dict()) - len(frozen)):
        fail(f"{name} training changed only {len(moved)} of "
             f"{len(fresh.state_dict()) - len(frozen)} tensors")
    cases = len(trainer._train_loader) * BATCH
    if len(trainer.clock.ms) != epochs * cases // BATCH:
        fail(f"{len(trainer.clock.ms)} step times for "
             f"{epochs * cases // BATCH} steps")
    return trainer, counts, peak, run_s


def _check_loop(name, trainer, epochs, mode):
    """The train split came through the native loader, and with ``mode``
    "host" through the host augmenter, every case of every epoch; returns
    the host augmentation's ms per case (empty without it)."""
    from transoar_tpu_torch.data.transforms import HostAugmentingLoader
    from transoar_tpu_torch.native.native_loader import NativeLoader

    loader = trainer._train_loader
    host = isinstance(loader, HostAugmentingLoader)
    if host != (mode == "host"):
        fail(f"{name}: train loader {type(loader).__name__} for "
             f"augmentation {mode}")
    native = loader._loader if host else loader
    if not isinstance(native, NativeLoader):
        fail(f"{name}: the train split came through "
             f"{type(native).__name__}, not the native loader")
    cases = epochs * len(loader) * BATCH
    augmented = len(loader.case_ms) if host else 0
    if native.served != cases or augmented != (cases if host else 0):
        fail(f"{name}: native loader served {native.served} cases, the "
             f"host augmenter ran on {augmented}, of {cases}")
    return loader.case_ms if host else []


def _training_result(trainer, epochs, counts, peak, run_s, case_ms):
    """The loop's figures. Step event ms: CUDA events around each step,
    which also hold any time the card waits for the host's enqueue (no
    device busy time). Per epoch the loop's volumes/s over its wall time
    and the share of that wall time outside the step events; for the last
    epoch the steady rate (its steps after the first over the host time
    between their starts: no augmenter or prefetch fill) and the shares of
    its wall time the main thread spent waiting for the loader, preparing
    the copies (cast, pinning, enqueue) and in the step calls."""
    clock = trainer.clock
    step_ms = clock.ms
    steps = len(step_ms)
    median = statistics.median(step_ms[1:])
    per_epoch = steps // epochs
    hist = [h for h in trainer.history if "train" in h]
    loop_s = [h["train_s"] for h in hist]
    outside = [1 - sum(step_ms[i * per_epoch:(i + 1) * per_epoch])
               / (1e3 * t) for i, t in enumerate(loop_s)]
    last = slice(steps - per_epoch, steps)
    starts = clock.start_s[last]
    host = {"loader": clock.loader_ms, "copy": clock.copy_ms,
            "step_call": clock.step_host_ms}
    if any(len(v) != steps for v in host.values()):
        fail(f"loop clock: {steps} steps, host times "
             f"{ {k: len(v) for k, v in host.items()} }")
    result = {"steps": steps, "step_event_ms": step_ms,
              "step_event_ms_median_after_first": median,
              "step_event_volumes_per_s": BATCH * 1e3 / median,
              "loop_s_per_epoch": loop_s,
              "loop_volumes_per_s_per_epoch": [
                  h["train_volumes"] / t for h, t in zip(hist, loop_s)],
              "loop_volumes_per_s_steady_last_epoch":
                  BATCH * (per_epoch - 1) / (starts[-1] - starts[0]),
              "loop_share_outside_step_events_per_epoch": outside,
              "loop_host_shares_last_epoch": {
                  k: sum(v[last]) / (1e3 * loop_s[-1])
                  for k, v in host.items()},
              "peak_memory_gib": peak / 2 ** 30,
              "launches": {k: v for k, v in counts.items() if v},
              "train_total_loss_per_epoch": [h["train"]["total"]
                                             for h in hist],
              "val_mAP_coco": [h["metrics"]["mAP_coco"]
                               for h in trainer.history if "metrics" in h],
              "run_s": run_s}
    if case_ms:
        result.update(host_aug_cases=len(case_ms),
                      host_aug_ms_per_case_median=statistics.median(case_ms),
                      host_aug_ms_per_case_mean=statistics.mean(case_ms))
    return result


def _roi_layers(cfg):
    """roi_gather_bwd launches a train step of ``cfg``'s model: one a
    decoder layer where a foc_attn neck takes the RoI path (as
    ``build_transoarnet`` decides), else none; a forward launches none."""
    neck = cfg["neck"]
    if "retina" in cfg or neck.get("name", "foc_attn") != "foc_attn" or \
            not neck.get("restrict_attn", True) or \
            not neck.get("roi_attention", True):
        return 0
    return int(neck["dec_layers"])


def _want_training(cfg, steps, val_batches, windows):
    want = {k: n * steps for k, n in STEP_LAUNCHES.items()}
    want["packed_conv"] += 2 * val_batches
    if windows:
        want.update(fused_window_attention=windows * (steps + val_batches),
                    fused_window_attention_bwd=windows * steps)
    if _roi_layers(cfg):
        want["roi_gather_bwd"] = _roi_layers(cfg) * steps
    return want


def _check_launches(path, counts, want):
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        fail(f"{path} launched {got}, want {want}")
    _check_variants(path, counts)
    _check_window_variants(path, counts)


def _write_amos_corpus(raw, cases, seed):
    """An AMOS-layout corpus (imagesTr/, labelsTr/) of ``cases`` synthetic
    CT cases off the flagship grid: 15 organs drawn on an inner grid
    (``data/synthetic.make_case``), padded with air so that no organ
    touches a face, in flipped-axes (LPS) NIfTI files."""
    from transoar_tpu_torch.data.nifti import write_nifti
    from transoar_tpu_torch.data.synthetic import make_case
    from transoar_tpu_torch.models.anchors import synthetic_bbox_props

    rng = np.random.default_rng(seed)
    props = synthetic_bbox_props(15, seed=seed)
    for sub in ("imagesTr", "labelsTr"):
        (raw / sub).mkdir(parents=True)
    for i in range(cases):
        inner = (224 + 8 * (i % 3), 232, 112 + 4 * (i % 2))
        image, label = make_case(rng, inner, props)
        pad = ((24, 20), (16, 28), (12, 10))
        image = np.pad(image * 400.0 - 1000.0, pad, constant_values=-1000.0)
        label = np.pad(label, pad)
        affine = np.diag([-0.8, -0.8, 2.5, 1.0])
        name = f"amos_{i:04d}.nii"
        write_nifti(image.astype(np.float32), raw / "imagesTr" / name,
                    affine=affine)
        write_nifti(label.astype(np.int16), raw / "labelsTr" / name,
                    affine=affine)


def phase_prepare(root):
    """prepare_dataset_amos on a synthetic raw corpus of TRAIN_CASES +
    VAL_CASES cases into root/dataset/amos_smoke at the flagship grid;
    returns the dataset's name if every case passed the AMOS filters with
    all 15 organs, else None (said on a printed line)."""
    import yaml

    from transoar_tpu_torch import prepare_dataset_amos
    from transoar_tpu_torch.utils.io import get_config, load_json

    from transoar_tpu_torch.presets import flagship_config

    cfg = get_config("dataset_amos")
    grid = list(flagship_config()["augmentation"]["patch_size"])
    cfg["preprocessing"].update(dataset_name="amos_smoke", resize_shape=grid,
                                num_train=TRAIN_CASES, num_val=VAL_CASES,
                                num_test=0)
    raw = Path(root) / "raw_amos"
    t0 = time.perf_counter()
    _write_amos_corpus(raw, TRAIN_CASES + VAL_CASES, SEED)
    raw_s = time.perf_counter() - t0
    (Path(root) / "dataset_amos_smoke.yaml").write_text(yaml.safe_dump(cfg))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        _reset_launches()
        t0 = time.perf_counter()
        out = prepare_dataset_amos.main([
            "--path_to_dataset", str(raw), "--config",
            str(Path(root) / "dataset_amos_smoke.yaml"),
            "--out", str(Path(root) / "dataset")])
        prep_s = time.perf_counter() - t0
        counts = {k: v for k, v in _counts().items() if v}
    finally:
        os.chdir(cwd)
    if counts:
        fail(f"prepare launched {counts}: it is host only")
    info = load_json(out / "data_info.json")
    kept = {split: sorted(p.name for p in (out / split).iterdir())
            for split in ("train", "val") if (out / split).exists()}
    for split, names in kept.items():
        for case in names:
            image = np.load(out / split / case / "data.npy", mmap_mode="r")
            label = np.load(out / split / case / "label.npy", mmap_mode="r")
            if image.shape != tuple(grid) or label.shape != tuple(grid) \
                    or image.dtype != np.float32 or label.dtype != np.int32:
                fail(f"prepare wrote {split}/{case}: {image.shape} "
                     f"{image.dtype}, {label.shape} {label.dtype}")
    stats = info["foreground_voxel_statistics"]
    if not all(np.isfinite(v) for v in stats.values()) or \
            info["shape_statistics"]["median"] != grid:
        fail(f"prepare's data_info.json: {stats}, "
             f"{info['shape_statistics']}")
    organs = sorted(int(k) for k in info["bbox_properties"])
    n_kept = {k: len(v) for k, v in kept.items()}
    print(f"prepare: prepare_dataset_amos on {TRAIN_CASES + VAL_CASES} "
          f"synthetic NIfTI cases off the grid (raw corpus {raw_s:.1f} s, "
          f"prepare {prep_s:.1f} s): kept {json.dumps(n_kept)}, organs "
          f"{organs}, window {stats['percentile_00_5']:.1f} .. "
          f"{stats['percentile_99_5']:.1f}", flush=True)
    if n_kept == {"train": TRAIN_CASES, "val": VAL_CASES} and \
            organs == list(range(1, 16)):
        return "amos_smoke"
    print(f"prepare: the AMOS filters kept {json.dumps(n_kept)} cases with "
          f"organs {organs}, not {TRAIN_CASES} + {VAL_CASES} with all 15: "
          f"phase 11 trains on a synthetic dataset instead", flush=True)
    return None


def phase_training(root, dataset):
    """The flagship as shipped (host augmentation through the native
    loader) for EPOCHS epochs; returns (counts, result)."""
    from transoar_tpu_torch.presets import flagship_config

    cfg = flagship_config(batch_size=BATCH)
    aug = cfg["augmentation"]
    if not aug["use_augmentation"] or aug["on_device"] or \
            cfg["trainer"]["num_workers"] <= 0:
        fail(f"foc_dec_amos no longer ships host augmentation with loader "
             f"threads: {aug['use_augmentation']}, {aug['on_device']}, "
             f"{cfg['trainer']['num_workers']}")
    trainer, counts, peak, run_s = _train(cfg, "foc_dec_amos_smoke", root,
                                          dataset, EPOCHS)
    case_ms = _check_loop("training", trainer, EPOCHS, "host")
    steps = EPOCHS * (TRAIN_CASES // BATCH)
    _check_launches("training", counts, _want_training(
        cfg, steps, (EPOCHS + 1) * (VAL_CASES // BATCH), 0))
    result = _training_result(trainer, EPOCHS, counts, peak, run_s, case_ms)
    print(f"training: foc_dec_amos 256x256x128 batch {BATCH} bf16 on "
          f"{dataset}, as shipped: host augmentation, "
          f"{cfg['trainer']['num_workers']} threads and as many cases in "
          f"flight, native loader; {json.dumps(result)}", flush=True)
    return counts, result


def phase_swin_training(root, dataset):
    from transoar_tpu_torch.presets import swin_fpn_config

    cfg = swin_fpn_config(batch_size=BATCH)
    if float(cfg["trainer"]["clip_max_norm"]) > 0:
        fail("swin_fpn_visceral clips its gradients: clip_max_norm > 0")
    if not cfg["augmentation"]["use_augmentation"] or \
            cfg["augmentation"]["on_device"]:
        fail("swin_fpn_visceral no longer ships host augmentation")
    trainer, counts, peak, run_s = _train(
        cfg, "swin_fpn_visceral_smoke", root, dataset, SWIN_EPOCHS)
    case_ms = _check_loop("Swin training", trainer, SWIN_EPOCHS, "host")
    steps = SWIN_EPOCHS * (SWIN_TRAIN_CASES // BATCH)
    _check_launches("swin_training", counts, _want_training(
        cfg, steps, (SWIN_EPOCHS + 1) * (SWIN_VAL_CASES // BATCH),
        SWIN_WINDOW_LAUNCHES))
    if peak >= 40 * 2 ** 30:
        fail(f"Swin training peak memory {peak / 2 ** 30:.2f} GiB >= 40")
    result = _training_result(trainer, SWIN_EPOCHS, counts, peak, run_s,
                              case_ms)
    grid = "x".join(map(str, cfg["augmentation"]["patch_size"]))
    print(f"swin training: swin_fpn_visceral {grid} batch {BATCH} bf16, as "
          f"shipped: host augmentation, native loader; {json.dumps(result)}",
          flush=True)
    return counts, result


def _device_aug_ms(cfg, root, dataset):
    """Median device ms of augment_batch on one train batch of the dataset
    (CUDA events, 10 runs); one call first under
    ``torch.cuda.set_sync_debug_mode("error")``: the augmentation never
    waits on the host."""
    from transoar_tpu_torch.data.transforms import augment_batch

    split = Path(root) / "dataset" / dataset / "train"
    cases = sorted(split.iterdir())[:BATCH]
    images = torch.as_tensor(np.stack([np.load(c / "data.npy")
                                       for c in cases]))[..., None].cuda()
    labels = torch.as_tensor(np.stack([np.load(c / "label.npy")
                                       for c in cases])).long().cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    aug = dict(cfg["augmentation"], on_device=True)
    stats = cfg["foreground_voxel_statistics"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = augment_batch(images, labels, gen, aug, stats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if out[0].shape != images.shape or out[1].shape != labels.shape or \
            not torch.isfinite(out[0]).all():
        fail("device augmentation: wrong shapes or non-finite values")
    return _median_ms(lambda: augment_batch(images, labels, gen, aug, stats),
                      runs=10, warmup=2)


def _long_split(root, dataset, cases):
    """root/dataset/<dataset>_x<cases>: a train split of ``cases`` links
    that cycle through the dataset's train cases, its val split and its
    data_info.json; returns the name."""
    src = Path(root) / "dataset" / dataset
    name = f"{dataset}_x{cases}"
    out = Path(root) / "dataset" / name
    if out.exists():  # made by an earlier phase
        return name
    (out / "train").mkdir(parents=True)
    real = sorted((src / "train").iterdir())
    for i in range(cases):
        (out / "train" / f"case_{i:04d}").symlink_to(real[i % len(real)])
    (out / "val").symlink_to(src / "val")
    (out / "data_info.json").write_bytes((src / "data_info.json")
                                         .read_bytes())
    return name


def phase_loop_variants(root, datasets):
    """Each model's train loop in every augmentation setting, one epoch of
    LOOP_STEPS steps each over a long split of links to its dataset (no
    checkpoints, one validation before): none, host as shipped
    (``num_workers`` threads and as many cases in flight), host one batch
    at a time (the JAX package's design: no case in flight beyond the
    batch handed out) and on the card (``on_device: true``); with each
    model's on-device augmentation timed alone. Returns (counts by path,
    results, the long splits by model)."""
    from transoar_tpu_torch.presets import flagship_config, swin_fpn_config

    variants = {"none": ({"use_augmentation": False}, None),
                "host": ({}, None),
                "host_one_batch": ({}, 0),
                "device": ({"on_device": True}, None)}
    cases = BATCH * LOOP_STEPS
    made = {d: _long_split(root, d, cases) for d in set(datasets.values())}
    long_splits = {model: made[d] for model, d in datasets.items()}
    counts_by_path, results = {}, {}
    for model, make, val, windows in (
            ("foc_dec_amos", flagship_config, VAL_CASES, 0),
            ("swin_fpn_visceral", swin_fpn_config, SWIN_VAL_CASES,
             SWIN_WINDOW_LAUNCHES)):
        for variant, (aug, ahead) in variants.items():
            cfg = make(batch_size=BATCH)
            cfg["augmentation"].update(aug)
            path = f"{model}_{variant}"
            trainer, counts, peak, run_s = _train(
                cfg, path, root, long_splits[model], LOOP_EPOCHS, debug=True,
                _host_ahead=ahead)
            mode = {"none": None, "device": "device"}.get(variant, "host")
            case_ms = _check_loop(path, trainer, LOOP_EPOCHS, mode)
            if mode == "host":
                want = cfg["trainer"]["num_workers"] if ahead is None \
                    else ahead
                if trainer._train_loader._ahead != want:
                    fail(f"{path}: host augmenter keeps "
                         f"{trainer._train_loader._ahead} cases in flight, "
                         f"not {want}")
            _check_launches(path, counts, _want_training(
                cfg, LOOP_EPOCHS * LOOP_STEPS, val // BATCH, windows))
            result = _training_result(trainer, LOOP_EPOCHS, counts, peak,
                                      run_s, case_ms)
            if variant == "device":
                result["device_aug_ms_per_batch"] = _device_aug_ms(
                    cfg, root, datasets[model])
            print(f"loop: {model} augmentation {variant}, "
                  f"{json.dumps(result)}", flush=True)
            counts_by_path[path], results[path] = counts, result
    return counts_by_path, results, long_splits


def _host_aug_scaling(root, dataset, threads=(1, 4, 8), cases=16):
    """Cases/s of augment_case_np alone (no training beside it) over the
    first ``cases`` train cases of the dataset with the flagship's shipped
    augmentation, on each thread count: what the host gives the augmenter
    when nothing else runs."""
    from transoar_tpu_torch.data.transforms import augment_case_np
    from transoar_tpu_torch.presets import flagship_config
    from transoar_tpu_torch.utils.io import load_json

    aug = flagship_config()["augmentation"]
    stats = load_json(Path(root) / "dataset" / dataset / "data_info.json")[
        "foreground_voxel_statistics"]
    split = Path(root) / "dataset" / dataset / "train"
    cases = [(np.load(c / "data.npy")[..., None], np.load(c / "label.npy"))
             for c in sorted(split.iterdir())[:cases]]
    rates = {}
    for n in threads:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(n) as pool:
            list(pool.map(lambda i: augment_case_np(*cases[i], i, aug,
                                                    stats),
                          range(len(cases))))
        rates[n] = len(cases) / (time.perf_counter() - t0)
    print(f"host augmentation alone: {len(cases)} flagship cases, cases/s "
          f"by thread count {json.dumps(rates)}", flush=True)


def _loop_summary(results):
    """One line: each model's loop in every augmentation setting side by
    side (phase 14): the epoch's rate, the steady rate, the share outside
    the step events, the main thread's shares, the step event median."""
    summary = {}
    for path, r in results.items():
        summary[path] = {
            "loop_volumes_per_s_last_epoch":
                r["loop_volumes_per_s_per_epoch"][-1],
            "loop_volumes_per_s_steady_last_epoch":
                r["loop_volumes_per_s_steady_last_epoch"],
            "loop_share_outside_step_events_last_epoch":
                r["loop_share_outside_step_events_per_epoch"][-1],
            "loop_host_shares_last_epoch": r["loop_host_shares_last_epoch"],
            "step_event_ms_median_after_first":
                r["step_event_ms_median_after_first"],
            **{k: r[k] for k in ("host_aug_ms_per_case_median",
                                 "device_aug_ms_per_batch") if k in r}}
    print(f"loop summary ({os.cpu_count()} host cores, "
          f"{len(os.sched_getaffinity(0))} usable): {json.dumps(summary)}",
          flush=True)


def _family_summary(results):
    """One line: phase 16's configs side by side (training: the step event
    median, peak memory, the matcher's median solve ms)."""
    summary = {name: {
        "step_event_ms_median_after_first":
            r["step_event_ms_median_after_first"],
        "peak_memory_gib": r["peak_memory_gib"],
        **({"matcher_solve_ms_median": r["matcher_host_ms"]["solve_median"]}
           if "matcher_host_ms" in r else {})} for name, r in results.items()}
    print(f"family summary: {json.dumps(summary)}", flush=True)


def _attention_weights_check():
    """The tiny f32 flagship's return_weights=True forward on the card
    against the CPU (1e-3)."""
    from transoar_tpu_torch.models.transoarnet import build_model
    from transoar_tpu_torch.utils.weights import random_state_dict

    cfg, _ = _tiny("flagship")
    x = np.random.default_rng(SEED).normal(
        size=(1, *cfg["augmentation"]["patch_size"], 1))
    outs = {}
    for device in ("cpu", "cuda"):
        model = build_model(cfg, dtype=torch.float32, device=device).eval()
        model.load_state_dict(random_state_dict(model, SEED))
        with torch.inference_mode():
            out = model(torch.as_tensor(x, dtype=torch.float32,
                                        device=device), return_weights=True)
        outs[device] = {k: v.float().cpu() for k, v in out.items()}
    errs = {}
    for key in ("attn_weights", "self_attn_weights"):
        torch.testing.assert_close(outs["cuda"][key], outs["cpu"][key],
                                   rtol=0, atol=1e-3)
        errs[key] = (outs["cuda"][key] - outs["cpu"][key]).abs().max().item()
    return errs


def _test_run(root, path, run, val, windows):
    """test.main --val on runs/<run> with every count at 0 before; finite
    mAPs in results_val.json and the path's launches; returns the counts."""
    from transoar_tpu_torch import test
    from transoar_tpu_torch.utils.io import load_json

    cwd = os.getcwd()
    os.chdir(root)
    try:
        _reset_launches()
        t0 = time.perf_counter()
        scores = test.main(["--run", run, "--val", "--data_dir",
                            str(Path(root) / "dataset")])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
    finally:
        os.chdir(cwd)
    written = load_json(Path(root) / "runs" / run / "results_val.json")
    maps = {k: v for k, v in written.items() if k.startswith("mAP")}
    if written != scores or not maps or \
            not all(np.isfinite(v) for v in maps.values()):
        fail(f"{path}: results_val.json {written}")
    maps = {k: v for k, v in maps.items()
            if not k.endswith("_")}  # per-organ keys end in "_"
    want = {"packed_conv": 2 * val}
    if windows:
        want["fused_window_attention"] = windows * val
    _check_launches(path, counts, want)
    print(f"{path}: test.py --val on {run}, {val} cases in {secs:.1f} s; "
          f"{json.dumps(maps)}; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}",
          flush=True)
    return counts


def phase_test(root):
    """test.main --val on the runs phases 11 and 13 trained; then the
    attention weights on the card against the CPU. Returns the counts by
    path."""
    counts_by_path = {
        "test": _test_run(root, "test", "foc_dec_amos_smoke", VAL_CASES, 0),
        "swin_test": _test_run(root, "swin_test", "swin_fpn_visceral_smoke",
                               SWIN_VAL_CASES, SWIN_WINDOW_LAUNCHES)}
    errs = _attention_weights_check()
    print(f"test: tiny flagship return_weights=True, card vs CPU max abs "
          f"diff {json.dumps(errs)}", flush=True)
    return counts_by_path


def phase_families(root, dataset):
    """Each of FAMILY_CONFIGS at full width as shipped (seeded random
    weights): predict.main on FAMILY_VOLUMES at batch 1, then train.train
    at batch 2 (host augmentation, native loader) for FAMILY_EPOCHS epochs
    of FAMILY_STEPS steps over links to the flagship dataset's train cases,
    with a validation before and after each; the band conv's launches on
    every path, peak memory under 40 GiB, and for the DETR necks the
    matcher's host ms. Returns (counts by path, results by config)."""
    from transoar_tpu_torch.presets import model_config

    split = _long_split(root, dataset, BATCH * FAMILY_STEPS)
    counts_by_path, results = {}, {}
    for name in FAMILY_CONFIGS:
        cfg = model_config(name)
        records, counts, peak = _serve(cfg, name, FAMILY_VOLUMES)
        path = f"{name}_serving"
        _check_launches(path, counts,
                        {"packed_conv": 2 * len(FAMILY_VOLUMES)})
        if peak >= 40 * 2 ** 30:
            fail(f"{path} peak memory {peak / 2 ** 30:.2f} GiB >= 40")
        _serving_line(path, cfg, records, peak, counts)
        counts_by_path[path] = counts

        cfg = model_config(name, batch_size=BATCH)
        aug = cfg["augmentation"]
        if not aug["use_augmentation"] or aug["on_device"] or \
                cfg["trainer"]["num_workers"] <= 0:
            fail(f"{name} no longer ships host augmentation with loader "
                 f"threads")
        path = f"{name}_training"
        trainer, counts, peak, run_s = _train(cfg, f"{name}_smoke", root,
                                              split, FAMILY_EPOCHS)
        case_ms = _check_loop(path, trainer, FAMILY_EPOCHS, "host")
        _check_launches(path, counts, _want_training(
            cfg, FAMILY_EPOCHS * FAMILY_STEPS,
            (FAMILY_EPOCHS + 1) * (VAL_CASES // BATCH), 0))
        if peak >= 40 * 2 ** 30:
            fail(f"{path} peak memory {peak / 2 ** 30:.2f} GiB >= 40")
        result = _training_result(trainer, FAMILY_EPOCHS, counts, peak,
                                  run_s, case_ms)
        clock = getattr(trainer._criterion, "clock", None)
        if clock is not None:
            # one call a train or val step, in the loop's order: the
            # validation before the epochs, then each epoch's steps and
            # its validation
            result["matcher_host_ms"] = {
                "calls": len(clock.solve_ms),
                "wait": clock.wait_ms, "solve": clock.solve_ms,
                "solve_median": statistics.median(clock.solve_ms)}
        grid = "x".join(map(str, aug["patch_size"]))
        print(f"{path}: {name} {grid} batch {BATCH} bf16, as shipped; "
              f"{json.dumps(result)}", flush=True)
        counts_by_path[path], results[name] = counts, result
    return counts_by_path, results


def _retina_validation_lists(trainer):
    """The validation split of the trained run through the trainer's eval
    step and the card's decode: the evaluator's ragged lists, one entry a
    volume (boxes [n, 6] finite, classes in 1..organs, scores at least the
    decode's 0.05, in NMS order within a class)."""
    from transoar_tpu_torch.models.retina import retina_inference

    organs = trainer._config["neck"]["num_organs"]
    kept = []
    for batch in trainer._prefetch(trainer._val_loader):
        losses, preds, _ = trainer._eval_step(batch)
        if set(preds) != {"anchor_logits", "anchor_deltas"}:
            fail(f"retina eval step predicted {sorted(preds)}")
        if not all(torch.isfinite(v).all() for v in losses.values()):
            fail(f"retina validation losses {losses}")
        boxes, classes, scores = retina_inference(
            preds, trainer._model.anchors, organs)
        n = batch["image"].shape[0]
        if not len(boxes) == len(classes) == len(scores) == n:
            fail(f"retina decode gave {len(boxes)} volumes of {n}")
        for b, c, sc in zip(boxes, classes, scores):
            if b.shape != (len(c), 6) or len(sc) != len(c) or \
                    c.dtype != np.int64 or not np.isfinite(b).all() or \
                    (len(c) and (c.min() < 1 or c.max() > organs
                                 or sc.min() < 0.05)):
                fail(f"retina decode lists: boxes {b.shape}, classes {c}, "
                     f"scores {sc}")
            kept.append(len(c))
        _check_nms(retina_inference(preds, trainer._model.anchors, organs,
                                    score_threshold=0.0), organs)
    return kept


def _check_nms(lists, organs, iou_threshold=0.5, max_out=50):
    """The NMS's own contract on decoded lists: every class keeps 1 to
    ``max_out`` boxes, in non-increasing score order, no two of which
    overlap above ``iou_threshold`` (IoU of the corner boxes)."""
    from transoar_tpu_torch.utils.boxes import (box_cxcyczwhd_to_xyzxyz,
                                                box_iou_pairwise)

    for boxes, classes, scores in zip(*lists):
        for c in range(1, organs + 1):
            mine = classes == c
            if not 1 <= mine.sum() <= max_out:
                fail(f"NMS kept {mine.sum()} boxes of class {c}")
            sc = scores[mine]
            if (np.diff(sc) > 0).any():
                fail(f"NMS kept class {c} out of score order: {sc}")
            corners = box_cxcyczwhd_to_xyzxyz(torch.as_tensor(boxes[mine]))
            iou, _ = box_iou_pairwise(corners, corners)
            iou.fill_diagonal_(0.0)
            if float(iou.max()) > iou_threshold + 1e-5:  # CPU rounding
                fail(f"NMS kept class {c} boxes overlapping at IoU "
                     f"{float(iou.max()):.3f}")


def _retina_decode_check():
    """retina_inference on the card against the CPU on a seeded input
    without ties (3,000 anchors, 4 classes, distinct scores): the same
    classes, boxes and scores within 1e-5; returns the boxes kept."""
    from transoar_tpu_torch.models.retina import retina_inference

    rng = np.random.default_rng(SEED)
    A, C = 3000, 4
    anchors = np.concatenate([rng.uniform(0.1, 0.9, (A, 3)),
                              rng.uniform(0.02, 0.2, (A, 3))], -1)
    logits = rng.permutation(A * C).reshape(1, A, C) / (A * C) * 8.0 - 4.0
    deltas = rng.normal(0.0, 0.5, (1, A, 6))
    got = {}
    for device in ("cpu", "cuda"):
        out = {"anchor_logits": torch.tensor(logits, dtype=torch.float32,
                                             device=device),
               "anchor_deltas": torch.tensor(deltas, dtype=torch.float32,
                                             device=device)}
        got[device] = retina_inference(out, torch.tensor(
            anchors, dtype=torch.float32, device=device), C)
    (cb, cc, cs), (gb, gc, gs) = got["cpu"], got["cuda"]
    if not np.array_equal(cc[0], gc[0]) or len(cc[0]) == 0:
        fail(f"retina decode card vs CPU classes {gc[0]} vs {cc[0]}")
    np.testing.assert_allclose(gs[0], cs[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(gb[0], cb[0], rtol=0, atol=1e-5)
    _check_nms(got["cuda"], C)
    return len(gc[0])


def _retina_test(root, path, run):
    """test.Tester --val on runs/<run> with every count at 0 before: finite
    mAPs, 2 packed_conv launches a case, and each case's forward and
    decode (``retina_inference``) CUDA-event ms; returns (counts, ms)."""
    from transoar_tpu_torch import test

    args = test.build_parser().parse_args(
        ["--run", run, "--val", "--data_dir", str(Path(root) / "dataset")])
    cwd = os.getcwd()
    os.chdir(root)
    try:
        _reset_launches()
        tester = test.Tester(args)
        scores = tester.run()
        torch.cuda.synchronize()
        counts = _counts()
    finally:
        os.chdir(cwd)
    maps = {k: v for k, v in scores.items()
            if k.startswith("mAP") and not k.endswith("_")}
    if not maps or not all(np.isfinite(v) for v in maps.values()):
        fail(f"{path}: scores {maps}")
    if len(tester.case_ms) != VAL_CASES:
        fail(f"{path}: {len(tester.case_ms)} cases timed of {VAL_CASES}")
    _check_launches(path, counts, {"packed_conv": 2 * VAL_CASES})
    ms = {k: [c[k] for c in tester.case_ms] for k in ("forward", "decode")}
    print(f"{path}: test CLI --val on {run}, {VAL_CASES} cases; CUDA-event "
          f"ms per case {json.dumps(ms)}; {json.dumps(maps)}; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}",
          flush=True)
    return counts, ms


def phase_retina(root, dataset):
    """retina_amos as shipped and Retina U-Net at full width (256x256x128,
    bf16, seeded random weights): train.train at batch 2 with host
    augmentation through the native loader (RETINA_RUNS' epochs of
    FAMILY_STEPS steps over links to the flagship dataset's train cases,
    a validation before and after each epoch), the band conv's launches,
    finite losses, every parameter moved but the regression tower's when
    no step had a positive anchor (then it must not have), peak memory
    under 40 GiB, the validation split decoded into the evaluator's lists
    and, with no score threshold, held to the NMS's contract; then the test CLI on the run. Returns
    (counts by path, results by config)."""
    from transoar_tpu_torch.models.retina import RetinaCriterion
    from transoar_tpu_torch.presets import model_config, retina_unet_config

    kept = _retina_decode_check()
    print(f"retina decode: card vs CPU on a seeded input without ties, "
          f"{kept} boxes kept, the same within 1e-5", flush=True)
    split = _long_split(root, dataset, BATCH * FAMILY_STEPS)
    counts_by_path, results = {}, {}
    assign = RetinaCriterion.assign
    positives = []

    def counting_assign(tgt_boxes, present, anchors):
        """The criterion's assignment, counting each train step's positive
        anchors on the card (read after the run)."""
        best_gt, best_iou = assign(tgt_boxes, present, anchors)
        if torch.is_grad_enabled():
            positives.append((best_iou >= cfg["retina"]["pos_iou"]).sum())
        return best_gt, best_iou

    def no_gradient():
        """Without a positive anchor in the run, the box losses are 0 and
        the regression tower gets no gradient."""
        return () if sum(int(n) for n in positives) else ("_reg_tower.",)

    for name, epochs in RETINA_RUNS:
        cfg = (retina_unet_config(BATCH) if name == "retina_unet_amos"
               else model_config(name, batch_size=BATCH))
        aug = cfg["augmentation"]
        if not aug["use_augmentation"] or aug["on_device"] or \
                cfg["trainer"]["num_workers"] <= 0 or \
                cfg["backbone"]["stage0_pack"] != 4:
            fail(f"{name} no longer ships host augmentation with loader "
                 f"threads and the packed stage 0")
        path = f"{name}_training"
        positives.clear()
        RetinaCriterion.assign = staticmethod(counting_assign)
        try:
            trainer, counts, peak, run_s = _train(
                cfg, f"{name}_smoke", root, split, epochs, still=no_gradient)
        finally:
            RetinaCriterion.assign = staticmethod(assign)
        case_ms = _check_loop(path, trainer, epochs, "host")
        _check_launches(path, counts, _want_training(
            cfg, epochs * FAMILY_STEPS, (epochs + 1) * (VAL_CASES // BATCH),
            0))
        if peak >= 40 * 2 ** 30:
            fail(f"{path} peak memory {peak / 2 ** 30:.2f} GiB >= 40")
        result = _training_result(trainer, epochs, counts, peak, run_s,
                                  case_ms)
        last = trainer.history[-1]["train"]
        if (last["segdice"] > 0) != (name == "retina_unet_amos"):
            fail(f"{path}: seg losses {last['segce']}, {last['segdice']}")
        result["train_positive_anchors_per_step"] = [int(n)
                                                     for n in positives]
        result["val_detections_per_volume"] = _retina_validation_lists(
            trainer)
        grid = "x".join(map(str, aug["patch_size"]))
        print(f"{path}: {name} {grid} batch {BATCH} bf16, "
              f"{len(trainer._model.anchors)} anchors, as shipped; "
              f"{json.dumps(result)}", flush=True)
        counts_by_path[path] = counts
        test_path = f"{name}_test"
        counts_by_path[test_path], result["test_ms"] = _retina_test(
            root, test_path, f"{name}_smoke")
        results[name] = result
    return counts_by_path, results


# phase 19: the flagship's train step under the multi-GPU wrappers, each
# run PARALLEL_STEPS steps from the plain step's weights and batches
PARALLEL_STEPS = 3
PARALLEL_WORLD1 = ("ddp", "fsdp", "tp")
# two ranks on one card talk over gloo (NCCL refuses two ranks on one
# device), which has no reduce-scatter for CUDA tensors (FSDP2's): there
# the fsdp check stays on the CPU (tests/test_torch_parallel.py)
PARALLEL_TWO_ONE_CARD = ("dp", "tp")
PARALLEL_TWO_CARDS = ("dp", "tp", "fsdp")
# the tiny train steps' tolerances (PERF.md section 2): loss, gradients
PARALLEL_LOSS_RTOL, PARALLEL_GRAD_REL = 1e-4, 1e-3


def _mode_layout(mode, world):
    """(dp, sp, tp, fsdp, tp_always) of a phase-19 or phase-20 mode:
    ``ddp`` / ``dp`` data parallel under DDP, ``fsdp`` under FSDP2, ``tp``
    the neck over every rank (at one rank over a one-rank group), ``sp``
    the volume's S0 over every rank (DDP over the dp x sp group)."""
    if mode == "tp":
        return 1, 1, world, False, world == 1
    if mode == "sp":
        return 1, world, 1, False, False
    return world, 1, 1, mode == "fsdp", False


def _full_grads(model, layout):
    """Every parameter's whole gradient under its reference name, on the
    card (a collective of every rank under a layout)."""
    from transoar_tpu_torch.parallel import fsdp as fsdp_lib
    from transoar_tpu_torch.parallel import tp as tp_lib

    grads = {n.removeprefix("module."): p.grad
             for n, p in model.named_parameters()}
    if layout is None:
        return grads
    grads = {n: g.full_tensor() if hasattr(g, "full_tensor") else g
             for n, g in grads.items()}
    plan = getattr(fsdp_lib.unwrap(model), "tp_plan", {})
    return tp_lib.gather_state(grads, plan, layout.tp_group, layout.tp)


def _parallel_steps(cfg, model, layout, batches, device,
                    steps=PARALLEL_STEPS):
    """``steps`` train steps (model in eval(): no dropout) on this rank's
    rows of each global batch, every count at 0 before: (losses, step
    event ms, the first step's whole gradients, counts (the wrappers' and,
    under ``"variants"``, the kernels' by variant), peak)."""
    from transoar_tpu_torch.models.criterion import build_criterion
    from transoar_tpu_torch.parallel.mesh import local_batch_rows
    from transoar_tpu_torch.training.train_state import make_optimizer
    from transoar_tpu_torch.training.trainer import make_train_step

    model.eval()
    optimizer, scheduler = make_optimizer(model, cfg, 1)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg, None, layout)
    rows = local_batch_rows(layout, BATCH)
    rows = slice(None) if rows is None else rows
    on_card = [{k: torch.from_numpy(batches[k][i][rows]).to(device)
                for k in ("image", "seg")} for i in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    losses, marks, grads = [], [], None
    for i, batch in enumerate(on_card):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        losses.append(step(batch)["total"])
        b.record()
        marks.append((a, b))
        if i == 0:
            grads = _full_grads(model, layout)
    torch.cuda.synchronize()
    return ([float(v) for v in losses], [a.elapsed_time(b) for a, b in marks],
            grads, dict(_counts(), variants=_variant_counts()),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _variant_counts():
    """The band conv's forward and dw and the window attention's forward
    and backward kernel launches by variant."""
    from transoar_tpu_torch.ops.kernels import window_attention as wa

    pc = _kernels()
    return {name: {k: v for k, v in table.items() if v} for name, table in (
        ("forward", pc.variant_launches), ("dw", pc.dw_variant_launches),
        ("window", wa.variant_launches),
        ("window_bwd", wa.bwd_variant_launches))}


def _grad_rel_l2(grads, ref):
    """The largest per-tensor rel-L2 of ``grads`` against ``ref`` over the
    tensors above 1e-5 of ref's global norm."""
    norm = float(torch.linalg.vector_norm(torch.stack(
        [g.float().norm() for g in ref.values()])))
    return max(float((grads[n].float() - g.float()).norm() / g.float().norm())
               for n, g in ref.items() if g.float().norm() > 1e-5 * norm)


def _parallel_rank(spec_path, out):
    """One rank of phase 19 (started by ``phase_parallel`` with torchrun's
    environment): on rank 0 the plain step, then on every rank each mode's
    steps from the same seeded weights; rank 0 writes the comparison,
    every rank its counts and peak memory."""
    import torch.distributed as dist

    from transoar_tpu_torch.models.transoarnet import build_model
    from transoar_tpu_torch.parallel.fsdp import parallelize
    from transoar_tpu_torch.parallel.mesh import (Layout, init_distributed,
                                                  make_mesh)

    spec = json.loads(Path(spec_path).read_text())
    out = Path(out)
    device = init_distributed(spec["device"], spec["backend"])
    cfg = spec["config"]
    batches = dict(np.load(out.parent / "batches.npz"))
    rank, world = dist.get_rank(), dist.get_world_size()

    def model(cfg):
        return build_model(cfg, device=device, generator=torch.Generator()
                           .manual_seed(int(cfg["seed"])))

    steps = spec.get("steps", PARALLEL_STEPS)
    results, mine = {}, {}
    try:
        for precision in spec.get("precisions", [None]):
            # phase 20 runs each precision in turn: its keys are suffixed
            tag = "" if precision is None else f"_{precision}"
            pcfg = cfg if precision is None else dict(
                cfg, trainer=dict(cfg["trainer"], precision=precision))
            if rank == 0:
                losses, ms, ref, counts, peak = _parallel_steps(
                    pcfg, model(pcfg), None, batches, device, steps)
                results["plain" + tag] = {"loss": losses,
                                          "step_event_ms": ms,
                                          "peak_gib": peak,
                                          "launches": counts}
            dist.barrier()
            for mode in spec["modes"]:
                dp, sp, tp, fsdp, always = _mode_layout(mode, world)
                layout = Layout(make_mesh(dp, sp, tp, "cuda"), fsdp=fsdp)
                wrapped = parallelize(model(pcfg), layout, device,
                                      tp_always=always)
                losses, ms, grads, counts, peak = _parallel_steps(
                    pcfg, wrapped, layout, batches, device, steps)
                mine[mode + tag] = {"launches": counts, "peak_gib": peak}
                if rank == 0:
                    results[mode + tag] = {
                        "loss": losses, "step_event_ms": ms,
                        "grad_rel_l2_max": _grad_rel_l2(grads, ref)}
                del wrapped, grads
                dist.barrier()
            if rank == 0:
                del ref
    finally:
        (out / f"rank{rank}.json").write_text(json.dumps(mine))
        if rank == 0:
            (out / "results.json").write_text(json.dumps(results))
        dist.destroy_process_group()


def _train_cli_rank(out, argv, backend=None):
    """One rank of ``train.main`` under torchrun (phases 19 and 20), every
    count at 0 before; writes its counts, peak memory and train history.
    ``backend``: join the process group over it first (gloo for two ranks
    sharing one card, which NCCL refuses); ``train.main`` keeps it."""
    from transoar_tpu_torch import train
    from transoar_tpu_torch.parallel.mesh import init_distributed

    if backend is not None:
        init_distributed(argv[argv.index("--device") + 1], backend)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    trainer = train.main(argv)
    record = {"launches": _counts(),
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "train_total": [h["train"]["total"] for h in trainer.history
                              if "train" in h],
              "step_event_ms": trainer.clock.ms}
    Path(out, f"cli.rank{os.environ['RANK']}.json").write_text(
        json.dumps(record))


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(args, world, cwd, timeout=600):
    """Start ``world`` processes of ``args`` with torchrun's environment
    (``world`` None: one process of ``args`` that sets it up itself) and
    wait for them; fails (after stopping them all) unless each exits 0."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    if world is None:
        envs = [env]
    else:
        env.update(WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(_free_port()))
        envs = [dict(env, RANK=str(r), LOCAL_RANK=str(r))
                for r in range(world)]
    procs = [subprocess.Popen(args, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=e)
             for e in envs]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [f"rank {r} exit {p.returncode}: {log[-3000:]}"
           for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    if bad:
        fail("; ".join(bad))


def _parallel_run(root, name, cfg, world, device, backend, modes):
    """Phase 19's ranks over ``modes``; checks each against the plain
    step and prints a line each; returns {path: rank 0's counts}."""
    out = Path(root) / "parallel" / name
    out.mkdir(parents=True)
    spec = out / "spec.json"
    spec.write_text(json.dumps({"config": cfg, "device": device,
                                "backend": backend, "modes": modes}))
    t0 = time.perf_counter()
    _run_ranks([sys.executable, str(Path(__file__).resolve()),
                "--parallel-rank", str(spec), str(out)], world,
               Path(__file__).parent)
    secs = time.perf_counter() - t0
    results = json.loads((out / "results.json").read_text())
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(world)]
    plain = results["plain"]
    want = _want_training(cfg, PARALLEL_STEPS, 0, 0)
    counts_by_path, failures = {}, []
    print(f"parallel {name}: plain step (one process, no wrapper) loss "
          f"{plain['loss']}, step event ms {plain['step_event_ms']}, peak "
          f"{plain['peak_gib']:.2f} GiB; {world} rank(s) over {backend} on "
          f"{device}, {secs:.1f} s", flush=True)
    for mode in modes:
        got = results[mode]
        rel = [abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                   plain["loss"])]
        for r, facts in enumerate(ranks):
            launched = {k: v for k, v in facts[mode]["launches"].items()
                        if v and k != "variants"}
            if launched != want:
                failures.append(f"parallel {name} {mode} rank {r} launched "
                                f"{launched}, want {want}")
        if max(rel) > PARALLEL_LOSS_RTOL or \
                got["grad_rel_l2_max"] > PARALLEL_GRAD_REL:
            failures.append(
                f"parallel {name} {mode}: loss {got['loss']} vs plain "
                f"{plain['loss']} (rel {max(rel):.2e}), gradient rel-L2 "
                f"{got['grad_rel_l2_max']:.2e}")
        path = f"parallel_{name}_{mode}"
        counts_by_path[path] = {k: v for k, v in
                                ranks[0][mode]["launches"].items()
                                if k != "variants"}
        print(f"{path}: loss {got['loss']} (largest rel. difference to "
              f"plain {max(rel):.2e}), first step's gradient rel-L2 max "
              f"{got['grad_rel_l2_max']:.2e}, step event ms "
              f"{got['step_event_ms']} (plain {plain['step_event_ms']}), "
              f"peak GiB per rank "
              f"{[round(f[mode]['peak_gib'], 2) for f in ranks]}, band conv "
              f"launches per rank {want}", flush=True)
    if failures:
        fail("; ".join(failures))
    return counts_by_path


def phase_parallel(root, dataset):
    """Multi-GPU training (``transoar_tpu_torch/parallel``) on the
    flagship at full width (256x256x128, batch 2, f32, seeded weights,
    PARALLEL_STEPS batches of phase 10's cases): (a) one rank over NCCL
    under DDP, FSDP2 and the tp code path; (b) two ranks (two cards over
    NCCL, else two processes sharing the card over gloo): dp 1 + 1 and tp
    2 (and FSDP2 on two cards), each against the plain one-process step;
    (c) ``train.main`` under torchrun with ``parallel.fsdp: true`` for one
    epoch of the phase-10 dataset as shipped, then ``test.main --val`` on
    its checkpoint in this process. Returns {path: counts}."""
    from transoar_tpu_torch.data.dataset import TransoarDataset
    from transoar_tpu_torch.presets import flagship_config
    from transoar_tpu_torch.utils.io import load_json

    cfg = flagship_config(batch_size=BATCH)
    cfg.update(load_json(Path(root) / "dataset" / dataset / "data_info.json"))
    cfg["dataset"] = dataset
    cfg["augmentation"]["use_augmentation"] = False  # the step windows
    # f32, as phase 8's small steps: in bf16 a rounding moved by a split
    # batch or a summed partial product grows over the steps past these
    # tolerances (a 1e-3 to 8e-3 loss difference by the third step). The
    # ranks keep cuDNN's default TF32 convs (without them a full-width f32
    # step takes 3.5 s and each process's first 16-29 s)
    cfg["trainer"]["precision"] = "float32"
    data = TransoarDataset(cfg, "train", data_dir=Path(root) / "dataset")
    cases = [data[i % len(data)] for i in range(PARALLEL_STEPS * BATCH)]
    (Path(root) / "parallel").mkdir()
    np.savez(Path(root) / "parallel" / "batches.npz",
             image=np.stack([c[0] for c in cases]).reshape(
                 PARALLEL_STEPS, BATCH, *cases[0][0].shape),
             seg=np.stack([c[1] for c in cases]).reshape(
                 PARALLEL_STEPS, BATCH, *cases[0][1].shape))
    cfg = json.loads(json.dumps(cfg, default=lambda o: o.tolist()))
    counts = _parallel_run(root, "world1", cfg, 1, "cuda", "nccl",
                           PARALLEL_WORLD1)
    if torch.cuda.device_count() >= 2:
        counts.update(_parallel_run(root, "2ranks", cfg, 2, "cuda", "nccl",
                                    PARALLEL_TWO_CARDS))
    else:
        counts.update(_parallel_run(root, "2ranks", cfg, 2, "cuda:0", "gloo",
                                    PARALLEL_TWO_ONE_CARD))
    counts.update(_parallel_train_cli(root, dataset))
    return counts


def _parallel_train_cli(root, dataset):
    """``python -m torch.distributed.run -m transoar_tpu_torch.train`` as
    a user starts it (here through ``_train_cli_rank`` to count the
    kernels), foc_dec_amos as shipped with ``parallel.fsdp: true``, one
    epoch; then the test CLI on its checkpoint."""
    import yaml

    from transoar_tpu_torch.presets import flagship_config

    nproc = 2 if torch.cuda.device_count() >= 2 else 1
    name = "foc_dec_amos_fsdp"
    cfg = flagship_config(batch_size=BATCH)
    cfg["parallel"]["fsdp"] = True
    cfg.update(experiment_name=name, dataset=dataset, debug_mode=False)
    cfg["trainer"].update(epochs=1, val_interval=1)
    for key in ("bbox_properties", "labels", "foreground_voxel_statistics"):
        cfg.pop(key, None)  # the dataset's data_info.json provides them
    path = Path(root) / f"{name}.yaml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(
        cfg, default=lambda o: o.tolist()))))
    out = Path(root) / "parallel" / "cli"
    out.mkdir()
    t0 = time.perf_counter()
    _run_ranks([sys.executable, "-m", "torch.distributed.run",
                f"--nproc_per_node={nproc}", f"--master_port={_free_port()}",
                str(Path(__file__).resolve()), "--train-cli-rank", str(out),
                "--config", str(path), "--data_dir",
                str(Path(root) / "dataset"), "--device", "cuda"], None, root)
    secs = time.perf_counter() - t0
    ranks = [json.loads((out / f"cli.rank{r}.json").read_text())
             for r in range(nproc)]
    steps = TRAIN_CASES // BATCH
    want = _want_training(cfg, steps, 2 * (VAL_CASES // BATCH), 0)
    for r, record in enumerate(ranks):
        launched = {k: v for k, v in record["launches"].items() if v}
        if launched != want or not np.isfinite(record["train_total"]).all():
            fail(f"parallel train CLI rank {r}: launched {launched}, want "
                 f"{want}; losses {record['train_total']}")
    saved = torch.load(Path(root) / "runs" / name / "model_last.pt",
                       map_location="cpu", weights_only=True)
    if any(k.startswith("module.") or type(v) is not torch.Tensor
           for k, v in saved["model"].items()):
        fail("parallel train CLI: the checkpoint is not the plain layout")
    print(f"parallel_train_cli: torchrun --nproc_per_node={nproc} -m "
          f"transoar_tpu_torch.train, foc_dec_amos as shipped with "
          f"parallel.fsdp: true, {steps} steps + 2 validations in "
          f"{secs:.1f} s; losses {ranks[0]['train_total']}, step event ms "
          f"{ranks[0]['step_event_ms']}, peak GiB per rank "
          f"{[round(r['peak_gib'], 2) for r in ranks]}; launches per rank "
          f"{want}", flush=True)
    counts = {"parallel_train_cli": ranks[0]["launches"]}
    counts["parallel_fsdp_test"] = _test_run(root, "parallel_fsdp_test",
                                             name, VAL_CASES, 0)
    return counts


# phase 20: spatial parallelism (``parallel.sp``) on both configs at full
# width, SP_STEPS steps from the seeded weights, first in f32 (cuDNN's TF32
# convs, as phase 19) then in bf16, each against the one-rank step of its
# precision
SP_STEPS = 2
SP_CONFIGS = (("foc_dec_amos", 0), ("swin_fpn_visceral",
                                    SWIN_WINDOW_LAUNCHES))
SP_PRECISIONS = ("float32", "bfloat16")
# bf16's first-step loss against the one-rank bf16 step: five bf16
# half-ulps (2^-9 each), as PERF.md section 6 argues
SP_BF16_LOSS_RTOL = 5 * 2.0 ** -9
# each precision's kernel variants: the f32 kernels, or the wgmma ones
SP_VARIANTS = {"float32": ({"fma"}, {"fma"}),
               "bfloat16": ({"fold", "wide"}, {"wg"})}


def _sp_run(root, name, cfg, windows, two_cards):
    """Phase 20's ranks on one config: the plain one-rank step, then sp over
    two ranks (two cards over NCCL, else two processes sharing the card
    over gloo), in each precision; checks every rank's launches and
    variants and the bounds, prints a line a precision; returns {path:
    rank 0's counts}."""
    from transoar_tpu_torch.data.dataset import TransoarDataset

    base = Path(root) / "sp" / name
    out = base / "ranks"
    out.mkdir(parents=True)
    data = TransoarDataset(cfg, "train", data_dir=Path(root) / "dataset")
    cases = [data[i % len(data)] for i in range(SP_STEPS * BATCH)]
    np.savez(base / "batches.npz",
             image=np.stack([c[0] for c in cases]).reshape(
                 SP_STEPS, BATCH, *cases[0][0].shape),
             seg=np.stack([c[1] for c in cases]).reshape(
                 SP_STEPS, BATCH, *cases[0][1].shape))
    device, backend = ("cuda", "nccl") if two_cards else ("cuda:0", "gloo")
    (out / "spec.json").write_text(json.dumps({
        "config": json.loads(json.dumps(cfg, default=lambda o: o.tolist())),
        "device": device, "backend": backend, "modes": ["sp"],
        "steps": SP_STEPS, "precisions": list(SP_PRECISIONS)}))
    t0 = time.perf_counter()
    _run_ranks([sys.executable, str(Path(__file__).resolve()),
                "--parallel-rank", str(out / "spec.json"), str(out)], 2,
               Path(__file__).parent)
    secs = time.perf_counter() - t0
    results = json.loads((out / "results.json").read_text())
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    want = _want_training(cfg, SP_STEPS, 0, windows)
    counts, failures = {}, []
    for precision in SP_PRECISIONS:
        tag = f"_{precision}"
        plain, got = results["plain" + tag], results["sp" + tag]
        rel = [abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                   plain["loss"])]
        conv, window = SP_VARIANTS[precision]
        for r, facts in enumerate(ranks):
            counted = facts["sp" + tag]["launches"]
            launched = {k: v for k, v in counted.items()
                        if v and k != "variants"}
            v = counted["variants"]
            if launched != want or set(v["forward"]) != conv or \
                    set(v["dw"]) != conv or \
                    set(v["window"]) != (window if windows else set()) or \
                    set(v["window_bwd"]) != (window if windows else set()):
                failures.append(f"sp {name} {precision} rank {r} launched "
                                f"{launched} by variant {v}, want {want} on "
                                f"{sorted(conv)} / {sorted(window)}")
        if precision == "float32":
            bad = max(rel) > PARALLEL_LOSS_RTOL or \
                got["grad_rel_l2_max"] > PARALLEL_GRAD_REL
        else:  # steps after an update drift apart in bf16 (PERF.md)
            bad = rel[0] > SP_BF16_LOSS_RTOL
        if bad:
            failures.append(
                f"sp {name} {precision}: loss {got['loss']} vs one rank "
                f"{plain['loss']} (rel {rel}), gradient rel-L2 "
                f"{got['grad_rel_l2_max']:.2e}")
        path = f"sp_{name}_{precision}"
        counts[path] = {k: v for k, v in
                        ranks[0]["sp" + tag]["launches"].items()
                        if k != "variants"}
        where = "two cards" if two_cards else (
            "two processes sharing one card: correctness and memory, not "
            "scaling")
        print(f"{path}: sp 2 over {backend} ({where}); loss {got['loss']} "
              f"(one rank "
              f"{plain['loss']}, rel. difference {rel}), first step's "
              f"gradient rel-L2 max {got['grad_rel_l2_max']:.2e}, step event "
              f"ms {got['step_event_ms']} (one rank "
              f"{plain['step_event_ms']}), peak GiB per rank "
              f"{[round(f['sp' + tag]['peak_gib'], 2) for f in ranks]} (one "
              f"rank {plain['peak_gib']:.2f}); launches per rank "
              f"{[f['sp' + tag]['launches'] for f in ranks]}; {secs:.1f} s "
              f"for both precisions", flush=True)
    if failures:
        fail("; ".join(failures))
    return counts


def _sp_train_cli(root, model, dataset, cases, windows, two_cards):
    """``python -m torch.distributed.run -m transoar_tpu_torch.train`` on
    ``model`` as shipped with ``parallel.sp: 2`` for one epoch of
    ``cases`` = (train, val) cases (through ``_train_cli_rank`` to count
    the kernels; two processes sharing one card talk over gloo); returns
    {path: rank 0's counts}."""
    import yaml

    from transoar_tpu_torch.presets import model_config

    name = f"{model}_sp"
    cfg = model_config(model, batch_size=BATCH)
    cfg["parallel"].update(dp=-1, sp=2)
    cfg.update(experiment_name=name, dataset=dataset, debug_mode=False)
    cfg["trainer"].update(epochs=1, val_interval=1)
    for key in ("bbox_properties", "labels", "foreground_voxel_statistics"):
        cfg.pop(key, None)  # the dataset's data_info.json provides them
    path = Path(root) / f"{name}.yaml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(
        cfg, default=lambda o: o.tolist()))))
    out = Path(root) / "sp" / f"cli_{model}"
    out.mkdir(parents=True)
    rank_flag, device = (("--train-cli-rank", "cuda") if two_cards
                         else ("--train-cli-rank-gloo", "cuda:0"))
    t0 = time.perf_counter()
    _run_ranks([sys.executable, "-m", "torch.distributed.run",
                "--nproc_per_node=2", f"--master_port={_free_port()}",
                str(Path(__file__).resolve()), rank_flag, str(out),
                "--config", str(path), "--data_dir",
                str(Path(root) / "dataset"), "--device", device], None, root)
    secs = time.perf_counter() - t0
    ranks = [json.loads((out / f"cli.rank{r}.json").read_text())
             for r in range(2)]
    steps = cases[0] // BATCH
    want = _want_training(cfg, steps, 2 * (cases[1] // BATCH), windows)
    for r, record in enumerate(ranks):
        launched = {k: v for k, v in record["launches"].items() if v}
        if launched != want or not np.isfinite(record["train_total"]).all():
            fail(f"sp train CLI {model} rank {r}: launched {launched}, want "
                 f"{want}; losses {record['train_total']}")
    saved = torch.load(Path(root) / "runs" / name / "model_last.pt",
                       map_location="cpu", weights_only=True)
    if any(k.startswith("module.") or type(v) is not torch.Tensor
           for k, v in saved["model"].items()):
        fail(f"sp train CLI {model}: the checkpoint is not the plain "
             f"layout")
    log = (Path(root) / "logs" / "train.log").read_text()
    if "mesh dp 1 x sp 2 x tp 1, DDP" not in log:
        fail("sp train CLI: the log names no dp 1 x sp 2 mesh")
    path = "sp_train_cli" if model == "foc_dec_amos" else \
        "sp_swin_train_cli"
    print(f"{path}: torchrun --nproc_per_node=2 -m "
          f"transoar_tpu_torch.train, {model} as shipped with "
          f"parallel.sp: 2 ({'NCCL' if two_cards else 'gloo, one card'}), "
          f"{steps} steps + 2 validations in {secs:.1f} s; losses "
          f"{ranks[0]['train_total']}, step event ms "
          f"{ranks[0]['step_event_ms']}, peak GiB per rank "
          f"{[round(r['peak_gib'], 2) for r in ranks]}; launches per rank "
          f"{want}", flush=True)
    return {path: ranks[0]["launches"]}


def phase_sp(root, datasets):
    """Spatial parallelism (``transoar_tpu_torch/parallel/sp.py``) at full
    width, batch 2, on the datasets of phases 10 and 13: foc_dec_amos (the
    packed band conv, kernels 1-3, on each rank's half of S0) and
    swin_fpn_visceral (kernels 1-3 and the window attention, 4-5, on the
    sharded Swin stages 2-4; stage 5 gathered), SP_STEPS steps at sp 2
    against the one-rank step in f32 and in bf16, then the train CLI with
    ``parallel.sp: 2`` on each. Returns {path: counts}."""
    from transoar_tpu_torch.presets import flagship_config, swin_fpn_config
    from transoar_tpu_torch.utils.io import load_json

    two_cards = torch.cuda.device_count() >= 2
    counts = {}
    for (name, windows), make in zip(SP_CONFIGS, (flagship_config,
                                                  swin_fpn_config)):
        cfg = make(batch_size=BATCH)
        cfg.update(load_json(Path(root) / "dataset" / datasets[name]
                             / "data_info.json"))
        cfg["dataset"] = datasets[name]
        cfg["augmentation"]["use_augmentation"] = False  # the step windows
        counts.update(_sp_run(root, name, cfg, windows, two_cards))
    for (name, windows), cases in zip(SP_CONFIGS, (
            (TRAIN_CASES, VAL_CASES), (SWIN_TRAIN_CASES, SWIN_VAL_CASES))):
        counts.update(_sp_train_cli(root, name, datasets[name], cases,
                                    windows, two_cards))
    return counts


# phase 21: ``transoar_tpu_torch.bench.main`` in this process, short:
# (warmup + steps) x scan_steps = 6 steps a batch size; each run's
# arguments, its path and the window launches a step (0: the flagship)
BENCH_ARGS = ["--steps", "2", "--warmup", "1", "--scan_steps", "2"]
BENCH_STEPS = 6
BENCH_RUNS = (("bench_train", [], 0), ("bench_eval", ["--mode", "eval"], 0),
              ("bench_swin_train", ["--config", "swin_fpn_visceral",
                                    "--batch_size", "2"],
               SWIN_WINDOW_LAUNCHES))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "device"}
# band conv launches per train step with remat off: the forward once
BENCH_STEP_LAUNCHES = {"packed_conv": 2, "packed_conv_dx": 1,
                       "packed_conv_dw": 2}


def _bench_want(args, windows):
    """Launches of one bench run: every step of every batch size."""
    sizes = [int(args[args.index("--batch_size") + 1])] \
        if "--batch_size" in args else [2, 1]
    if "eval" in args:  # a forward per volume
        volumes = BENCH_STEPS * sum(sizes)
        want = {"packed_conv": 2 * volumes}
        if windows:
            want["fused_window_attention"] = windows * volumes
        return want
    from transoar_tpu_torch.presets import model_config

    steps = BENCH_STEPS * len(sizes)
    want = {k: n * steps for k, n in BENCH_STEP_LAUNCHES.items()}
    if windows:
        want.update(fused_window_attention=windows * steps,
                    fused_window_attention_bwd=windows * steps)
    name = args[args.index("--config") + 1] if "--config" in args \
        else "foc_dec_amos"
    roi = _roi_layers(model_config(name))
    if roi:
        want["roi_gather_bwd"] = roi * steps
    return want


def _bench_busy(batch_size, steps=3):
    """The flagship's bench step at ``batch_size``: (device busy ms a step
    under torch.profiler, event ms a step without it, idle share = 1 -
    busy / event ms; the profiler's host work would inflate its own
    window's event time)."""
    from transoar_tpu_torch import bench

    _, step = bench.build_benchmark(batch_size, (256, 256, 128))
    step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        step()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    # the port's spans are mirrored on the device's timeline as ranges,
    # which are no work
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))
    busy_ms = busy / 1e3 / steps
    if busy_ms <= 0:
        fail("bench: the profiler recorded no device time")
    return busy_ms, event_ms, 1.0 - busy_ms / event_ms


def phase_bench():
    """``python -m transoar_tpu_torch.bench`` in this process (BENCH_RUNS,
    cuDNN's default TF32 as the CLI runs), each run's one stdout line
    checked against bench.py's keys, its values finite and > 0, its
    launches those of remat off; then the flagship's bench step at batch 2
    under the profiler, against which the batch-2 value must not exceed
    2 / busy seconds. Returns {path: counts}."""
    import contextlib
    import io

    from transoar_tpu_torch import bench

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    counts, values = {}, {}
    t0 = time.perf_counter()
    try:
        for path, args, windows in BENCH_RUNS:
            out = io.StringIO()
            _reset_launches()
            with contextlib.redirect_stdout(out):
                bench.main(BENCH_ARGS + args)
            counts[path] = _counts()
            lines = out.getvalue().splitlines()
            if len(lines) != 1:
                fail(f"{path}: bench printed {len(lines)} lines, want 1")
            result = json.loads(lines[0])
            keys = BENCH_KEYS | ({"batch1_volumes_per_sec",
                                  "batch1_vs_baseline"}
                                 if "--batch_size" not in args else set())
            if set(result) != keys:
                fail(f"{path}: bench keys {sorted(result)}, want "
                     f"{sorted(keys)}")
            for key in ("value", "batch1_volumes_per_sec"):
                v = result.get(key, 1.0)
                if not (np.isfinite(v) and v > 0):
                    fail(f"{path}: bench {key} {v}")
            _check_launches(path, counts[path], _bench_want(args, windows))
            values[path] = result["value"]
            print(f"bench: {path} {lines[0]}", flush=True)
        busy_ms, event_ms, idle = _bench_busy(2)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    ceiling = 2e3 / busy_ms
    if values["bench_train"] > ceiling:
        fail(f"bench: flagship batch 2 at {values['bench_train']} "
             f"volumes/s, above 2 / busy seconds = {ceiling:.4f}: the "
             f"timed window missed work")
    print(f"bench: flagship train step at batch 2: device busy "
          f"{busy_ms:.2f} ms under the profiler, event {event_ms:.2f} ms "
          f"a step without it, "
          f"idle share {idle:.4f}; 2 / busy s = {ceiling:.4f} volumes/s >= "
          f"the bench's {values['bench_train']}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def _entry(name, replaces, launches, rows, path_rows,
           source="transoar_tpu_torch/csrc/packed_conv.cu"):
    """One kernel of the result line; times and bounds sum the path's
    shapes, one launch each."""
    summed = [k for k in ("ms", "generic_ms", "call_ms", "plain_ms",
                          "bound_ms", "library_ms", "fwd_bwd_ms",
                          "library_fwd_bwd_ms")
              if k in path_rows[0]]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{k: sum(r[k] for r in path_rows) for k in summed},
        "bound_by": ("operations" if any(r["bound_by"] == "operations"
                                         for r in path_rows) else "bytes"),
        "shapes": [r for r in rows if "ms" in r],
    }


def main():
    from transoar_tpu_torch.presets import flagship_config, swin_fpn_config

    phase_device()
    phase_build()
    fwd_rows = phase_kernel()
    dx_rows, dw_rows = phase_backward()
    win_rows, win_bwd_rows = phase_window_kernels()
    conv2d_rows = phase_conv2d()
    roi_rows = phase_roi_gather()
    for kind in SMALL_MODELS:
        phase_small_model(kind)
        if kind in SMALL_TRAIN:
            phase_small_train(kind)
    paths = {"serving": phase_serving()}
    with tempfile.TemporaryDirectory() as root:
        datasets = {"foc_dec_amos": phase_prepare(root)}
        for model, make, cases, val in (
                ("foc_dec_amos", flagship_config, TRAIN_CASES, VAL_CASES),
                ("swin_fpn_visceral", swin_fpn_config, SWIN_TRAIN_CASES,
                 SWIN_VAL_CASES)):
            if datasets.get(model) is None:
                datasets[model], secs = _dataset(root, make(), cases, val)
                print(f"dataset: {datasets[model]}, {cases} + {val} "
                      f"synthetic cases in {secs:.1f} s", flush=True)
        paths["training"], _ = phase_training(
            root, datasets["foc_dec_amos"])
        paths["swin_serving"] = phase_swin_serving()
        paths["swin_training"], _ = phase_swin_training(
            root, datasets["swin_fpn_visceral"])
        variant_counts, loop_results, long_splits = phase_loop_variants(
            root, datasets)
        paths.update(variant_counts)
        paths.update(phase_test(root))
        _host_aug_scaling(root, long_splits["foc_dec_amos"])
        family_counts, family_results = phase_families(
            root, datasets["foc_dec_amos"])
        paths.update(family_counts)
        paths["def_detr_amos_test"] = _test_run(
            root, "def_detr_amos_test", "def_detr_amos_smoke", VAL_CASES, 0)
        retina_counts, retina_results = phase_retina(
            root, datasets["foc_dec_amos"])
        paths.update(retina_counts)
        family_results.update(retina_results)
        paths.update(phase_parallel(root, datasets["foc_dec_amos"]))
        paths.update(phase_sp(root, datasets))
    paths.update(phase_bench())
    _loop_summary(loop_results)
    _family_summary(family_results)
    src = "transoar_tpu/ops/pallas/packed_conv.py"
    wsrc = "transoar_tpu/ops/pallas/window_attention.py"
    timed = [r for r in win_rows if "ms" in r]

    def flagship(rows):
        return [r for r in rows if r.get("path") == "training"]

    kernels = [
        _entry("packed_conv", f"{src}:166",
               paths["training"]["packed_conv"], fwd_rows,
               flagship(fwd_rows)),
        _entry("packed_conv_dx", f"{src}:233",
               paths["training"]["packed_conv_dx"], dx_rows,
               flagship(dx_rows)),
        _entry("packed_conv_dw", f"{src}:191",
               paths["training"]["packed_conv_dw"], dw_rows,
               flagship(dw_rows)),
        _entry("fused_window_attention", f"{wsrc}:140",
               paths["swin_training"]["fused_window_attention"], win_rows,
               timed, "transoar_tpu_torch/csrc/window_attention.cu"),
        _entry("fused_window_attention_bwd", f"{wsrc}:159",
               paths["swin_training"]["fused_window_attention_bwd"],
               win_bwd_rows, [r for r in win_bwd_rows if "ms" in r],
               "transoar_tpu_torch/csrc/window_attention.cu"),
        _entry("conv2d_3x3", "transoar_tpu/ops/pallas/conv2d.py:43",
               sum(p["conv2d_3x3"] for p in paths.values()), conv2d_rows,
               conv2d_rows),
        # no TPU kernel: the JAX package leaves the gather's backward to XLA
        _entry("roi_gather_bwd", None, paths["training"]["roi_gather_bwd"],
               roi_rows, [r for r in roi_rows
                          if r["config"] == "foc_dec_amos"],
               "transoar_tpu_torch/csrc/roi_gather.cu"),
    ]
    for entry in kernels:
        entry["launches_by_path"] = {p: c[entry["name"]]
                                     for p, c in paths.items()}
    # one kernel function under packed_conv and packed_conv_dx (and
    # conv2d_3x3): its launches on each path by variant; the same for dw
    kernels[0]["forward_kernel_variants_by_path"] = VARIANTS_BY_PATH
    kernels[2]["dw_kernel_variants_by_path"] = DW_VARIANTS_BY_PATH
    # the window attention's forward and backward kernel launches by
    # variant on each path
    kernels[3]["window_kernel_variants_by_path"] = WINDOW_VARIANTS_BY_PATH
    kernels[4]["window_kernel_variants_by_path"] = \
        WINDOW_BWD_VARIANTS_BY_PATH
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:  # phase 19's ranks
        _parallel_rank(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--train-cli-rank"]:
        _train_cli_rank(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:2] == ["--train-cli-rank-gloo"]:  # phase 20, one card
        _train_cli_rank(sys.argv[2], sys.argv[3:], "gloo")
    else:
        main()
