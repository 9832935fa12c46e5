"""Training loop of the port (twin of ``transoar_tpu/training/trainer.py``).

- ``derive_targets``: per-organ boxes from the segmentation batch, on the
  device (``utils/boxes.segmentation2bbox``).
- ``make_train_step``: undo the transfer compression, the intensity window
  (when the config has ``foreground_voxel_statistics``), targets, forward
  (dropout masks from the step's generator), criterion, ``total_loss``,
  backward, global-norm clipping, then AdamW and the schedule. With
  ``trainer.nan_guard: skip`` a non-finite loss drops the update, the
  moments and the step count (one host sync per step); ``error`` raises at
  the end of the epoch. Plain batching: ``trainer.microbatch``,
  ``steps_per_dispatch`` and ``xla_options`` are accepted and change
  nothing (on the JAX side they are TPU dispatch and layout choices whose
  equality with plain batching its tests pin).
- ``make_eval_step``: the same up to the losses, without gradients; returns
  losses, predictions and targets.
- ``Trainer``: host batches compressed for the copy (image bf16 unless
  ``trainer.h2d_dtype`` or ``precision`` says f32, seg int8), copied from
  pinned memory on a copy stream, two batches ahead of the step, so the
  copies overlap the step on the compute stream; loss scalars stay on the
  device and are read once per epoch; validation with the evaluator, the
  best checkpoint on ``mAP_coco`` and ``model_last`` every epoch. Each
  epoch's history holds the train loop's wall time, loader included, and
  the volumes it stepped.
"""

from __future__ import annotations

import collections
import logging
import time
from pathlib import Path

import numpy as np
import torch

from transoar_tpu_torch.data.transforms import eval_transform
from transoar_tpu_torch.eval.evaluator import build_evaluator
from transoar_tpu_torch.models.criterion import build_criterion, total_loss
from transoar_tpu_torch.training import checkpoints as ckpt_lib
from transoar_tpu_torch.training.inference import inference
from transoar_tpu_torch.training.train_state import (clip_grad_norm,
                                                     current_lrs,
                                                     make_optimizer)
from transoar_tpu_torch.utils.boxes import segmentation2bbox

logger = logging.getLogger(__name__)

_PRED_KEYS = ("pred_logits", "pred_boxes")


def derive_targets(seg, num_classes, bbox_padding=1):
    """Box targets of a label batch, on its device."""
    boxes, present = segmentation2bbox(seg, num_classes, padding=bbox_padding)
    return {"boxes": boxes, "present": present, "seg": seg}


def _check_augmentation(config):
    if config.get("augmentation", {}).get("use_augmentation"):
        raise NotImplementedError(
            "augmentation.use_augmentation: true is not ported yet: ROADMAP "
            "Queue 1, item 2 (augmentation); set it to false")


def _prepare(batch, stats):
    """Undo the transfer compression; apply the intensity window."""
    image = batch["image"].float()
    if stats is not None:
        image = eval_transform(image, stats)
    return image, batch["seg"].long()


def make_train_step(model, criterion, optimizer, scheduler, config,
                    generator=None):
    """``step(batch) -> {loss name: device scalar}``; ``batch`` holds the
    device tensors ``image`` [B, S0, S1, S2, 1] and ``seg`` [B, S0, S1, S2].
    The step leaves the model's train/eval mode as it finds it."""
    _check_augmentation(config)
    tcfg = config["trainer"]
    coefs = config["loss_coefs"]
    num_classes = config["neck"]["num_organs"]
    padding = config.get("bbox_padding", 1)
    stats = config.get("foreground_voxel_statistics")
    clip = float(tcfg.get("clip_max_norm", -1))
    nan_guard = tcfg.get("nan_guard", "off")
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch):
        image, seg = _prepare(batch, stats)
        targets = derive_targets(seg, num_classes, padding)
        out = model(image, generator=generator)
        losses = criterion(out, targets, model.anchors)
        loss = total_loss(losses, coefs)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if clip > 0:
            clip_grad_norm(params, clip)
        if nan_guard != "skip" or torch.isfinite(loss).item():
            optimizer.step()
            scheduler.step()
        losses["total"] = loss
        return {k: v.detach() for k, v in losses.items()}

    return train_step


def make_eval_step(model, criterion, config):
    """``step(batch) -> (losses, preds, targets)``, device tensors."""
    coefs = config["loss_coefs"]
    num_classes = config["neck"]["num_organs"]
    padding = config.get("bbox_padding", 1)
    stats = config.get("foreground_voxel_statistics")

    @torch.no_grad()
    def eval_step(batch):
        image, seg = _prepare(batch, stats)
        targets = derive_targets(seg, num_classes, padding)
        out = model(image)
        losses = criterion(out, targets, model.anchors)
        losses["total"] = total_loss(losses, coefs)
        return losses, {k: out[k] for k in _PRED_KEYS}, targets

    return eval_step


class _StepClock:
    """Per-step times: CUDA events on the card (read after the epoch's one
    sync), the host clock on the CPU."""

    def __init__(self, device):
        self._cuda = device.type == "cuda"
        self._marks = []
        self.ms = []

    def start(self):
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append([ev])
        else:
            self._marks.append([time.perf_counter()])

    def stop(self):
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks[-1].append(ev)
        else:
            self._marks[-1].append(time.perf_counter())

    def collect(self):
        """Move the finished steps' times into ``ms`` (after a sync)."""
        for a, b in self._marks:
            self.ms.append(a.elapsed_time(b) if self._cuda
                           else 1e3 * (b - a))
        self._marks = []


class Trainer:
    def __init__(self, config, model, train_loader, val_loader, path_to_run,
                 device="cuda", optimizer=None, scheduler=None,
                 start_epoch=0, metric_start_val=0.0):
        _check_augmentation(config)
        self._config = config
        self._device = torch.device(device)
        self._model = model
        self._train_loader = train_loader
        self._val_loader = val_loader
        self._path_to_run = Path(path_to_run)
        self._epoch_to_start = start_epoch
        self._metric_max_val = metric_start_val
        self._main_metric_key = "mAP_coco"
        tcfg = config["trainer"]
        for key in ("microbatch", "steps_per_dispatch", "xla_options"):
            if tcfg.get(key):
                logger.info("trainer.%s=%r: plain batching on this device",
                            key, tcfg[key])

        if optimizer is None:
            optimizer, scheduler = make_optimizer(
                model, config, max(len(train_loader), 1))
        self.optimizer, self.scheduler = optimizer, scheduler
        default_h2d = ("float32" if str(tcfg.get("precision", "bfloat16"))
                       == "float32" else "bfloat16")
        self._h2d_bf16 = str(tcfg.get("h2d_dtype", default_h2d)) == "bfloat16"
        self._generator = torch.Generator(device=self._device).manual_seed(
            int(config.get("seed", 0)))
        self._copy_stream = (torch.cuda.Stream(self._device)
                             if self._device.type == "cuda" else None)

        criterion = build_criterion(config)
        self._evaluator = build_evaluator(config)
        self._train_step = make_train_step(model, criterion, optimizer,
                                           scheduler, config, self._generator)
        self._eval_step = make_eval_step(model, criterion, config)
        self.clock = _StepClock(self._device)
        self.history = []  # one {"epoch", "train"/"val"/"metrics"} per epoch

    # -- data placement ----------------------------------------------------
    def _device_batch(self, batch):
        """Host numpy batch -> device tensors, compressed for the copy:
        image bf16 (the model computes in bf16; the window is applied after
        the copy), seg int8 (lossless below 128 organs)."""
        image = torch.from_numpy(np.ascontiguousarray(batch["image"]))
        if self._h2d_bf16 and image.dtype == torch.float32:
            image = image.to(torch.bfloat16)
        seg = np.asarray(batch["seg"])
        if self._config["neck"]["num_organs"] < 128:
            seg = seg.astype(np.int8)
        seg = torch.from_numpy(np.ascontiguousarray(seg))
        if self._copy_stream is None:
            return {"image": image.to(self._device),
                    "seg": seg.to(self._device)}, None
        host = {"image": image.pin_memory(), "seg": seg.pin_memory()}
        with torch.cuda.stream(self._copy_stream):
            out = {k: v.to(self._device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record()
        return out, done

    def _ready(self, batch, done):
        """Make the compute stream wait for this batch's copy only, and
        keep its memory until the compute stream is through with it."""
        if done is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            for v in batch.values():
                v.record_stream(stream)
        return batch

    def _prefetch(self, loader, depth=3):
        """Keep ``depth`` batches copied or in flight: the copies of the
        next two batches run on the copy stream beside the current step."""
        buf = collections.deque()
        for batch in loader:
            buf.append(self._device_batch(batch))
            if len(buf) >= depth:
                yield self._ready(*buf.popleft())
        while buf:
            yield self._ready(*buf.popleft())

    # -- loops -------------------------------------------------------------
    def _train_one_epoch(self, epoch):
        self._model.train()
        step_losses, volumes = [], 0
        for device_batch in self._prefetch(self._train_loader):
            self.clock.start()
            step_losses.append(self._train_step(device_batch))
            self.clock.stop()
            volumes += device_batch["image"].shape[0]
        means, bad = {}, []
        if step_losses:
            stacked = {k: torch.stack([s[k] for s in step_losses]).cpu()
                       for k in step_losses[0]}  # the epoch's one sync
            self.clock.collect()
            bad = sorted(k for k, v in stacked.items()
                         if not torch.isfinite(v).all())
            means = {k: float(v.double().mean()) for k, v in stacked.items()}
        if bad and self._config["trainer"].get("nan_guard") == "error":
            raise RuntimeError(
                f"non-finite training loss in epoch {epoch}: {bad} "
                f"(trainer.nan_guard: error)")
        return means, volumes

    def _validate(self, epoch):
        self._model.eval()
        agg, count = {}, 0
        num_organs = self._config["neck"]["num_organs"]
        for device_batch in self._prefetch(self._val_loader):
            losses, preds, targets = self._eval_step(device_batch)
            for key, val in losses.items():
                agg[key] = agg.get(key, 0.0) + float(val)
            count += 1
            preds = {k: v.cpu().numpy() for k, v in preds.items()}
            boxes, classes, scores = inference(preds, num_organs)
            tgt_boxes = targets["boxes"].cpu().numpy()
            tgt_present = targets["present"].cpu().numpy()
            gt_boxes = [tb[tp] for tb, tp in zip(tgt_boxes, tgt_present)]
            gt_classes = [np.nonzero(tp)[0] + 1 for tp in tgt_present]
            self._evaluator.add(boxes, classes, scores, gt_boxes, gt_classes)

        means = {k: v / max(count, 1) for k, v in agg.items()}
        metric_scores = self._evaluator.eval()
        self._evaluator.reset()
        metric = metric_scores[self._main_metric_key]
        if metric >= self._metric_max_val and \
                not self._config.get("debug_mode"):
            self._metric_max_val = metric
            ckpt_lib.save_training_checkpoint(
                self._path_to_run, f"model_best_{metric:.3f}", self._model,
                self.optimizer, self.scheduler, epoch, self._metric_max_val)
        return means, metric_scores

    def run(self):
        cfg = self._config["trainer"]
        if self._epoch_to_start == 0:  # initial estimate, as the reference
            val, metrics = self._validate(0)
            self.history.append({"epoch": 0, "val": val, "metrics": metrics})
        for epoch in range(self._epoch_to_start + 1, cfg["epochs"] + 1):
            t0 = time.monotonic()
            train, volumes = self._train_one_epoch(epoch)
            record = {"epoch": epoch, "train": train,
                      "train_s": time.monotonic() - t0,
                      "train_volumes": volumes,
                      "lr": current_lrs(self.optimizer)}
            if epoch % cfg["val_interval"] == 0:
                record["val"], record["metrics"] = self._validate(epoch)
            if not self._config.get("debug_mode"):
                ckpt_lib.save_training_checkpoint(
                    self._path_to_run, "model_last", self._model,
                    self.optimizer, self.scheduler, epoch,
                    self._metric_max_val)
            self.history.append(record)
            logger.info("epoch %d done in %.1fs total_loss=%.4f mAP_coco=%s",
                        epoch, time.monotonic() - t0,
                        record["train"].get("total", float("nan")),
                        record.get("metrics", {}).get("mAP_coco"))
