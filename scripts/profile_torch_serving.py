"""Where the port's serving forward, or its train step, spends its time,
on the card.

    python scripts/profile_torch_serving.py [--config NAME] [--train] \
        [--bench B] [--steps 5] [--trace PATH]

Builds a full-width model of transoar_tpu_torch (``--config foc_dec_amos``,
the default: 256x256x128; ``swin_fpn_visceral``: 160x160x256 with Swin
stages 2-5; or, at 256x256x128, ``foc_dec_seg_amos`` (the seg proxy's
full-resolution decoder and head), ``foc_dec_refine_amos`` (the deformable
refine of P3-P5), ``detr_amos``, ``def_detr_amos``, ``retina_amos``
(RetinaNet: the shared towers over P2-P4, 1,345,536 anchors) or
``retina_unet_amos`` (retina_amos with the seg proxy)), bf16 compute, seeded
random weights, on the CUDA device, warms
up, and then reports for ``--steps`` forwards of one volume (serving, batch
1) or, with ``--train``, train steps at batch 2
(``training.trainer.make_train_step``: forward with dropout and DropPath,
criterion, backward with the CNN stages' remat recompute, AdamW;
augmentation off, two synthetic cases). With ``--bench B`` it profiles
the step of ``python -m transoar_tpu_torch.bench`` at batch B instead
(``bench.build_benchmark`` with ``--train``, else
``bench.build_eval_benchmark``: remat off, the bench's synthetic batch,
B volumes served one at a time with their decode), whose busy time bounds
the bench's value (at most B / busy seconds):

- wall ms per forward / step (host clock around work that ends in a
  synchronize); for RetinaNet the serving forward is followed by its decode
  (``retina_inference``: top-500 candidates a class, the batched NMS, the
  kept slots to the host), whose CUDA-event ms are reported apart;
- device ms per module (CUDA events around each encoder stage, the FPN
  decoder (the refine included), the refine alone, the neck, the
  box-regression head, RetinaNet's two towers and the seg head, summed over a step's completed
  calls; in training an encoder stage's remat recompute stops early and is
  not among them);
- kernel time by name from ``torch.profiler`` (device busy time, idle
  share = 1 - busy / wall): the 15 largest, and every one of the port's
  own kernels (csrc/) with its ms and launches per forward / step; the 15
  aten ops with the most device time under them (kernels they launch,
  nested ops' included: ``aten::grid_sampler_3d`` and its backward, the
  attention's ``aten::bmm``, ``aten::cudnn_convolution``...); with
  ``--trace``, a chrome trace;
- with ``--train`` the criterion's forward (matching, targets and losses)
  between CUDA events, per step;
- with ``--train`` and a DETR neck, the exact matcher's host ms per step
  (``SetCriterion.clock``: the cost's copy to the host, which waits for the
  forward, and the solve with the copy back).

Needs one CUDA card; imports no jax.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from transoar_tpu_torch import bench  # noqa: E402
from transoar_tpu_torch.data.synthetic import make_case  # noqa: E402
from transoar_tpu_torch.models.criterion import build_criterion  # noqa: E402
from transoar_tpu_torch.models.retina import retina_inference  # noqa: E402
from transoar_tpu_torch.models.transoarnet import build_model  # noqa: E402
from transoar_tpu_torch.presets import (model_config,  # noqa: E402
                                        retina_unet_config)
from transoar_tpu_torch.training.train_state import (  # noqa: E402
    make_optimizer)
from transoar_tpu_torch.training.trainer import make_train_step  # noqa: E402
from transoar_tpu_torch.utils.weights import random_state_dict  # noqa: E402


# the kernels of csrc/packed_conv.cu and csrc/window_attention.cu, by name
PORT_KERNEL = re.compile(r"::((?:(?:conv|dw)_(?:wide|fold|mma|fma)|dw_reduce"
                         r"|(?:fwd|bwd)_(?:mma|fma|wg)|dbias_reduce)(?:<\d+>)?)\(")
CONFIGS = ("foc_dec_amos", "swin_fpn_visceral", "foc_dec_seg_amos",
           "foc_dec_refine_amos", "detr_amos", "def_detr_amos",
           "retina_amos", "retina_unet_amos")


def _timed_modules(model):
    """CUDA events around every call of the timed modules: {name: [(start,
    end), ...]}. A remat recompute that stops early (after the last tensor
    the backward needs) has no end and is not counted."""
    mods = {f"encoder.stage{i}": m
            for i, m in enumerate(model._backbone._encoder._stages)}
    mods["fpn_decoder"] = model._backbone._decoder
    if hasattr(model._backbone._decoder, "_refine"):
        mods["refine"] = model._backbone._decoder._refine
    for name in ("neck", "reg_head", "cls_tower", "reg_tower"):
        if hasattr(model, f"_{name}"):
            mods[name] = getattr(model, f"_{name}")
    if hasattr(model, "_seg_head"):
        mods["seg_head"] = model._seg_head
    events = {name: [] for name in mods}
    pending = {}

    def hooks(name):
        def pre(_mod, _args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            pending[name] = ev

        def post(_mod, _args, _out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name].append((pending.pop(name), ev))
        return pre, post

    for name, mod in mods.items():
        pre, post = hooks(name)
        mod.register_forward_pre_hook(pre)
        mod.register_forward_hook(post)
    return events


def _serving(cfg, model):
    """One volume at batch 1 in eval mode: ``run()`` is a forward."""
    model.eval()
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(1, *cfg["augmentation"]["patch_size"], 1)),
        dtype=torch.float32, device="cuda")

    decode_ms = []

    @torch.inference_mode()
    def run():
        out = model(x)
        if "anchor_logits" in out:  # RetinaNet: its decode, timed apart
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            retina_inference(out, model.anchors, cfg["neck"]["num_organs"])
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            decode_ms.append(start.elapsed_time(end))
    run.decode_ms = decode_ms
    return run


def _training(cfg, model):
    """Two synthetic cases at batch 2 in train mode: ``run()`` is a train
    step (seg int8 and image bf16 on the card, as the Trainer sends them)."""
    model.train()
    rng = np.random.default_rng(0)
    cases = [make_case(rng, cfg["augmentation"]["patch_size"],
                       cfg["bbox_properties"]) for _ in range(2)]
    batch = {"image": torch.as_tensor(np.stack([c[0] for c in cases])[
                 ..., None]).to("cuda", torch.bfloat16),
             "seg": torch.as_tensor(np.stack([c[1] for c in cases])).to(
                 "cuda", torch.int8)}
    optimizer, scheduler = make_optimizer(model, cfg, 1)
    criterion = build_criterion(cfg)
    events = []

    def timed_criterion(*args, **kwargs):
        """The criterion's forward between CUDA events."""
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        losses = criterion(*args, **kwargs)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        events.append((start, end))
        return losses

    step = make_train_step(model, timed_criterion, optimizer, scheduler, cfg,
                           torch.Generator(device="cuda").manual_seed(0))
    run = lambda: step(batch)  # noqa: E731
    run.criterion = criterion
    run.criterion_events = events
    return run


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="foc_dec_amos",
                        choices=CONFIGS,
                        help="Which full-width model to profile.")
    parser.add_argument("--train", action="store_true",
                        help="Profile the batch-2 train step instead.")
    parser.add_argument("--bench", type=int, default=None, metavar="B",
                        help="Profile transoar_tpu_torch.bench's step at "
                             "batch B instead.")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--trace", type=str, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)

    if args.bench:
        batch = args.bench
        build = (bench.build_benchmark if args.train
                 else bench.build_eval_benchmark)
        patch = bench.bench_config(args.config)["augmentation"]["patch_size"]
        model, run = build(batch, tuple(patch), args.config)
    else:
        batch = 2 if args.train else 1
        cfg = (retina_unet_config(batch)
               if args.config == "retina_unet_amos"
               else model_config(args.config, batch_size=batch))
        cfg["augmentation"]["use_augmentation"] = False
        model = build_model(cfg, device="cpu")
        model.load_state_dict(random_state_dict(model, 0))
        model = model.cuda()
        run = (_training if args.train else _serving)(cfg, model)
    torch.cuda.reset_peak_memory_stats()

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    decode_ms = getattr(run, "decode_ms", [])
    decode_ms.clear()
    crit_events = getattr(run, "criterion_events", [])
    crit_events.clear()
    events = _timed_modules(model)
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    # per module: device ms per step over its completed calls (encoder
    # stages in training: the forward, plus any recompute that completes)
    calls = {name: len(evs) / args.steps for name, evs in events.items()}
    per_module = {name: sum(s.elapsed_time(e) for s, e in evs) / args.steps
                  for name, evs in events.items()}
    for evs in events.values():
        evs.clear()
    decode = list(decode_ms)
    crit_ms = [a.elapsed_time(b) for a, b in crit_events]

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        sys.exit("the profiler recorded no device kernels")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps
    wall = statistics.median(walls)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    ours = [e for e in kernels if PORT_KERNEL.search(e.key)]
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::") and e.device_time_total > 0),
                 key=lambda e: -e.device_time_total)[:15]
    unit = "step" if args.train or args.bench else "forward"
    clock = getattr(getattr(run, "criterion", None), "clock", None)
    matcher = None if clock is None else {
        "calls": len(clock.solve_ms),
        "wait_ms_median": statistics.median(clock.wait_ms),
        "solve_ms_median": statistics.median(clock.solve_ms)}
    print(json.dumps({
        "device": smi,
        "config": args.config,
        "mode": "%s%s, batch %d" % ("bench " if args.bench else "",
                                     "train step" if args.train
                                     else "serving", batch),
        f"wall_ms_per_{unit}": walls,
        "wall_ms_median": wall,
        f"device_busy_ms_per_{unit}": busy,
        "idle_share": 1.0 - busy / wall,
        "module_device_ms": per_module,
        "module_calls_per_step": calls,
        f"top_kernels_ms_per_{unit}": [
            [e.key[:90], e.self_device_time_total / 1e3 / args.steps,
             e.count // args.steps] for e in top],
        f"port_kernels_ms_per_{unit}": {
            PORT_KERNEL.search(e.key).group(1): [
                e.self_device_time_total / 1e3 / args.steps,
                e.count // args.steps] for e in ours},
        f"top_ops_device_ms_per_{unit}": [
            [e.key, e.device_time_total / 1e3 / args.steps,
             e.count // args.steps] for e in ops],
        "matcher_host_ms": matcher,
        "retina_decode_event_ms": decode or None,
        "criterion_forward_event_ms": crit_ms or None,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }, indent=1))


if __name__ == "__main__":
    main()
