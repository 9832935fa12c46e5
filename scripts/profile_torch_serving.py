"""Where the port's serving forward, or its train step, spends its time,
on the card.

    python scripts/profile_torch_serving.py [--train] [--steps 5] \
        [--trace PATH]

Builds the full-width foc_dec_amos model of transoar_tpu_torch (256x256x128,
bf16 compute, seeded random weights) on the CUDA device, warms up, and then
reports for ``--steps`` forwards of one volume (serving, batch 1) or, with
``--train``, train steps at batch 2 (``training.trainer.make_train_step``:
forward with dropout, criterion, backward with the encoder's remat
recompute, AdamW; augmentation off, two synthetic cases):

- wall ms per forward / step (host clock around work that ends in a
  synchronize);
- device ms per module (CUDA events around each encoder stage, the FPN
  decoder, the Focused Decoder neck and the box-regression head, summed
  over a step's completed calls; in training an encoder stage's remat
  recompute stops early and is not among them);
- kernel time by name from ``torch.profiler`` (device busy time, idle
  share = 1 - busy / wall) and, with ``--trace``, a chrome trace.

Needs one CUDA card; imports no jax.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from transoar_tpu_torch.data.synthetic import make_case  # noqa: E402
from transoar_tpu_torch.models.criterion import build_criterion  # noqa: E402
from transoar_tpu_torch.models.transoarnet import build_model  # noqa: E402
from transoar_tpu_torch.presets import flagship_config  # noqa: E402
from transoar_tpu_torch.training.train_state import (  # noqa: E402
    make_optimizer)
from transoar_tpu_torch.training.trainer import make_train_step  # noqa: E402
from transoar_tpu_torch.utils.weights import random_state_dict  # noqa: E402


def _timed_modules(model):
    """CUDA events around every call of the timed modules: {name: [(start,
    end), ...]}. A remat recompute that stops early (after the last tensor
    the backward needs) has no end and is not counted."""
    mods = {f"encoder.stage{i}": m
            for i, m in enumerate(model._backbone._encoder._stages)}
    mods["fpn_decoder"] = model._backbone._decoder
    mods["neck"] = model._neck
    mods["reg_head"] = model._reg_head
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

    @torch.inference_mode()
    def run():
        model(x)
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
    step = make_train_step(model, build_criterion(cfg), optimizer,
                           scheduler, cfg,
                           torch.Generator(device="cuda").manual_seed(0))
    return lambda: step(batch)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--train", action="store_true",
                        help="Profile the batch-2 train step instead.")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--trace", type=str, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)

    cfg = flagship_config(batch_size=2 if args.train else 1)
    cfg["augmentation"]["use_augmentation"] = False
    model = build_model(cfg, device="cpu")
    model.load_state_dict(random_state_dict(model, 0))
    model = model.cuda()
    run = (_training if args.train else _serving)(cfg, model)
    torch.cuda.reset_peak_memory_stats()

    for _ in range(3):
        run()
    torch.cuda.synchronize()
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
    unit = "step" if args.train else "forward"
    print(json.dumps({
        "device": smi,
        "mode": "train step, batch 2" if args.train else "serving, batch 1",
        f"wall_ms_per_{unit}": walls,
        "wall_ms_median": wall,
        f"device_busy_ms_per_{unit}": busy,
        "idle_share": 1.0 - busy / wall,
        "module_device_ms": per_module,
        "module_calls_per_step": calls,
        f"top_kernels_ms_per_{unit}": [
            [e.key[:90], e.self_device_time_total / 1e3 / args.steps,
             e.count // args.steps] for e in top],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }, indent=1))


if __name__ == "__main__":
    main()
