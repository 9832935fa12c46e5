"""Benchmark of the port: CT volumes/s on one CUDA card (twin of the JAX
package's ``bench.py``, same flags and the same JSON line, plus
``--device``).

    python -m transoar_tpu_torch.bench [--config NAME] [--mode train|eval] \
        [--batch_size N] [--patch S0 S1 S2] [--steps 10] [--warmup 3] \
        [--scan_steps 8] [--microbatch auto|on|off|grads] [--device cuda]

``--mode train`` (the headline) times the full train step that ``Trainer``
runs (``training.trainer.make_train_step``: targets derived on the device,
forward, matcher and criterion, backward, clipping, AdamW and the schedule)
of the flagship (``foc_dec_amos``) or of ``--config`` (a shipped config
name, ``retina_unet_amos`` or a ``.yaml`` path) with synthetic dataset
statistics, seeded weights and ``backbone.remat`` off, on one synthetic
batch reused for every step. ``--mode eval`` times serving: the
deterministic forward in ``eval()`` under ``torch.inference_mode``, one
volume at a time, each followed by the decode that ``predict`` / ``test``
run for the family (``training/inference.inference`` on the host for the
query necks, ``models/retina.retina_inference`` on the card for
RetinaNet). By default both batch sizes are measured, 2 (the headline)
and then 1.

Timing: ``warmup x scan_steps`` steps, a synchronize, a CUDA event, the
``steps x scan_steps`` timed steps (an event after each), an event, a
synchronize. The window holds every step whole, the host's enqueue gaps
and the DETR necks' matcher sync included, and reads no loss. The value is
``batch x scan_steps x steps / seconds``, as ``bench.py`` counts it.

Two flags keep their JAX names and change what they drive:
``--scan_steps`` multiplies the count of steps (the JAX tool fuses them
into one dispatch; the port loops over them) and ``--microbatch`` is
accepted and ignored, as the port's trainer ignores
``trainer.microbatch`` (plain batching; the JAX package pins its result
equal to plain batching).

stdout gets exactly one JSON line: ``bench.py``'s keys with the same
values' formulas and metric string, plus ``device`` (the card's name and
its power limit from ``nvidia-smi``). Per batch size the median step event
ms and the peak device memory go to stderr. Runs on the card unless
``--device cpu`` (for the tests) is asked for; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from transoar_tpu_torch.models.criterion import build_criterion
from transoar_tpu_torch.models.retina import retina_inference
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.presets import (flagship_config, model_config,
                                        retina_unet_config)
from transoar_tpu_torch.training.inference import inference
from transoar_tpu_torch.training.train_state import make_optimizer
from transoar_tpu_torch.training.trainer import make_train_step

REFERENCE_VOLUMES_PER_SEC = 2.0  # bench.py's documented estimate
SEED = 0


def _device(name):
    """``name`` as a device; a CUDA device without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on a CUDA card and none is "
                           "available (--device cpu only for the tests)")
    return device


def bench_config(config_name, batch_size=None, patch=None):
    """The flagship, or ``config_name`` (a shipped config, its
    ``retina_unet_amos`` variant or a ``.yaml`` path), with synthetic
    dataset statistics at ``batch_size`` and ``patch``; encoder remat off,
    as ``bench.py`` sets it."""
    if not config_name:
        config = flagship_config(batch_size, patch)
    elif config_name == "retina_unet_amos":
        config = retina_unet_config(batch_size, patch)
    else:
        config = model_config(config_name, batch_size, patch)
    config["backbone"]["remat"] = False
    return config


def synthetic_batch(config, batch_size, patch):
    """``bench.py``'s batch as numpy: an N(0, 1) f32 image [B, *patch, 1]
    and an int32 seg with one cuboid per class at its
    ``bbox_properties`` median, at least 8 voxels a side."""
    rng = np.random.default_rng(SEED)
    image = rng.normal(size=(batch_size, *patch, 1)).astype(np.float32)
    seg = np.zeros((batch_size, *patch), np.int32)
    for cls, props in config["bbox_properties"].items():
        c = np.asarray(props["median"][:3]) * np.asarray(patch)
        s = np.maximum(np.asarray(props["median"][3:]) * np.asarray(patch), 8)
        lo = np.maximum((c - s / 2).astype(int), 0)
        hi = np.minimum((c + s / 2).astype(int), patch)
        seg[:, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = int(cls)
    return image, seg


def _model(config, device):
    """``build_model`` on ``device``, parameters from a seeded generator."""
    return build_model(config, device=device,
                       generator=torch.Generator().manual_seed(SEED))


def build_benchmark(batch_size, patch, config_name=None, device="cuda"):
    """(model, step): ``step()`` runs one train step on the synthetic
    batch, which stays on the device."""
    device = _device(device)
    config = bench_config(config_name, batch_size, patch)
    model = _model(config, device)
    optimizer, scheduler = make_optimizer(model, config, steps_per_epoch=100)
    train_step = make_train_step(
        model, build_criterion(config), optimizer, scheduler, config,
        torch.Generator(device=device).manual_seed(SEED))
    image, seg = synthetic_batch(config, batch_size, patch)
    batch = {"image": torch.as_tensor(image, device=device),
             "seg": torch.as_tensor(seg, device=device)}
    return model, lambda: train_step(batch)


def build_eval_benchmark(batch_size, patch, config_name=None,
                         device="cuda"):
    """(model, step): ``step()`` serves the batch's volumes one at a time,
    forward then the family's decode."""
    device = _device(device)
    config = bench_config(config_name, batch_size, patch)
    model = _model(config, device).eval()
    image = torch.as_tensor(np.random.default_rng(SEED).normal(
        size=(batch_size, *patch, 1)).astype(np.float32), device=device)
    organs = config["neck"]["num_organs"]
    rcfg = config.get("retina")

    def decode(out):
        if rcfg is not None:
            return retina_inference(
                out, model.anchors, organs,
                iou_threshold=rcfg.get("nms_iou", 0.5),
                score_threshold=rcfg.get("score_threshold", 0.05))
        return inference({k: out[k].float().cpu().numpy()
                          for k in ("pred_logits", "pred_boxes")}, organs)

    @torch.inference_mode()
    def step():
        for b in range(batch_size):
            decode(model(image[b:b + 1]))

    return model, step


def _mark(device):
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _ms(a, b):
    return 1e3 * (b - a) if isinstance(a, float) else a.elapsed_time(b)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(step, warmup, count, device, label):
    """Seconds of ``count`` calls of ``step`` after ``warmup`` calls, between
    CUDA events on the card (the host clock on the CPU); the median call's
    ms and the peak device memory to stderr."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(warmup):
        step()
    _sync(device)
    marks = [_mark(device)]
    for _ in range(count):
        step()
        marks.append(_mark(device))
    _sync(device)
    seconds = _ms(marks[0], marks[-1]) / 1e3
    steps_ms = [_ms(a, b) for a, b in zip(marks, marks[1:])]
    print(json.dumps({
        "bench": label, "device": str(device), "steps": count,
        "seconds": seconds, "step_event_ms_median": statistics.median(
            steps_ms),
        "peak_memory_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                            if device.type == "cuda" else None)}),
        file=sys.stderr, flush=True)
    return seconds


def measure_eval(batch_size, patch, steps, warmup, scan_steps,
                 config_name=None, device="cuda"):
    device = _device(device)
    _, step = build_eval_benchmark(batch_size, patch, config_name, device)
    seconds = _timed(step, warmup * scan_steps, steps * scan_steps, device,
                     f"{config_name or 'foc_dec_amos'} eval, batch "
                     f"{batch_size}")
    return (batch_size * scan_steps * steps) / seconds


def measure(batch_size, patch, steps, warmup, scan_steps, microbatch,
            config_name=None, device="cuda"):
    """``microbatch`` is accepted and ignored (plain batching)."""
    device = _device(device)
    _, step = build_benchmark(batch_size, patch, config_name, device)
    seconds = _timed(step, warmup * scan_steps, steps * scan_steps, device,
                     f"{config_name or 'foc_dec_amos'} train, batch "
                     f"{batch_size}")
    return (batch_size * scan_steps * steps) / seconds


def device_info(device):
    """The card's name (torch) and power limit in W (``nvidia-smi``)."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit_w": None}
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return {"name": torch.cuda.get_device_name(device),
            "power_limit_w": float(smi.split(",")[-1].split()[0])}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch_size", type=int, default=None,
                        help="measure one batch size only (default: both "
                             "2 — the reference workload, headline — and 1)")
    parser.add_argument("--config", type=str, default=None,
                        help="bench a shipped variant config (detr_amos, "
                             "def_detr_amos, retina_amos, retina_unet_amos, "
                             "swin_fpn_visceral, ...) or a .yaml path "
                             "instead of the flagship")
    parser.add_argument("--patch", type=int, nargs=3, default=None,
                        help="volume shape (default: the config's own "
                             "patch_size; 256 256 128 for the flagship)")
    parser.add_argument("--steps", type=int, default=10,
                        help="timed rounds of scan_steps steps")
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--scan_steps", type=int, default=8,
                        help="steps per round (the JAX tool fuses them into "
                             "one dispatch)")
    parser.add_argument("--microbatch",
                        choices=["auto", "on", "off", "grads"],
                        default="auto",
                        help="accepted and ignored: plain batching")
    parser.add_argument("--mode", choices=["train", "eval"], default="train",
                        help="train = full training step (the official "
                             "headline); eval = serving forward + decode")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default); cpu for the tests only")
    args = parser.parse_args(argv)
    device = _device(args.device)

    if args.patch is not None:
        patch = tuple(args.patch)
    elif args.config:
        patch = tuple(bench_config(args.config)["augmentation"]["patch_size"])
    else:
        patch = (256, 256, 128)
    sizes = [args.batch_size] if args.batch_size else [2, 1]
    if args.mode == "eval":
        vols = {
            b: measure_eval(b, patch, args.steps, args.warmup,
                            args.scan_steps, args.config, device)
            for b in sizes
        }
    else:
        vols = {
            b: measure(b, patch, args.steps, args.warmup, args.scan_steps,
                       args.microbatch, args.config, device)
            for b in sizes
        }

    headline = sizes[0]
    kind = ("train step" if args.mode == "train"
            else "inference fwd+decode")
    name = args.config if args.config else "Focused Decoder"
    result = {
        "metric": "CT volumes/sec/chip (%s %s, "
                  "%dx%dx%d, batch %d)" % (name, kind, *patch, headline),
        "value": round(vols[headline], 4),
        "unit": "volumes/sec",
        "vs_baseline": round(vols[headline] / REFERENCE_VOLUMES_PER_SEC, 4),
    }
    for b in sizes[1:]:
        result[f"batch{b}_volumes_per_sec"] = round(vols[b], 4)
        result[f"batch{b}_vs_baseline"] = round(
            vols[b] / REFERENCE_VOLUMES_PER_SEC, 4)
    result["device"] = device_info(device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
