"""Where the port's serving forward spends its time, on the card.

    python scripts/profile_torch_serving.py [--steps 5] [--trace PATH]

Builds the full-width foc_dec_amos model of transoar_tpu_torch (256x256x128,
batch 1, bf16 compute, seeded random weights) on the CUDA device, warms up,
and then reports for ``--steps`` forwards of one volume:

- wall ms per forward (host clock around work that ends in a synchronize);
- device ms per module (CUDA events around each encoder stage, the FPN
  decoder, the Focused Decoder neck and the box-regression head);
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

from transoar_tpu_torch.models.transoarnet import build_model  # noqa: E402
from transoar_tpu_torch.presets import flagship_config  # noqa: E402
from transoar_tpu_torch.utils.weights import random_state_dict  # noqa: E402


def _timed_modules(model):
    mods = {f"encoder.stage{i}": m
            for i, m in enumerate(model._backbone._encoder._stages)}
    mods["fpn_decoder"] = model._backbone._decoder
    mods["neck"] = model._neck
    mods["reg_head"] = model._reg_head
    events = {name: [] for name in mods}

    def hooks(name):
        def pre(_mod, _args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name].append([ev])

        def post(_mod, _args, _out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1].append(ev)
        return pre, post

    for name, mod in mods.items():
        pre, post = hooks(name)
        mod.register_forward_pre_hook(pre)
        mod.register_forward_hook(post)
    return events


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--trace", type=str, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)

    cfg = flagship_config()
    model = build_model(cfg, device="cpu")
    model.load_state_dict(random_state_dict(model, 0))
    model = model.cuda().eval()
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(1, *cfg["augmentation"]["patch_size"], 1)),
        dtype=torch.float32, device="cuda")

    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        events = _timed_modules(model)
        walls = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        per_module = {name: statistics.median(s.elapsed_time(e)
                                              for s, e in evs)
                      for name, evs in events.items()}
        for evs in events.values():
            evs.clear()

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.steps):
                model(x)
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
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print(json.dumps({
        "device": smi,
        "wall_ms_per_forward": walls,
        "wall_ms_median": wall,
        "device_busy_ms_per_forward": busy,
        "idle_share": 1.0 - busy / wall,
        "module_device_ms": per_module,
        "top_kernels_ms_per_forward": [
            [e.key[:90], e.self_device_time_total / 1e3 / args.steps,
             e.count // args.steps] for e in top],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }, indent=1))


if __name__ == "__main__":
    main()
