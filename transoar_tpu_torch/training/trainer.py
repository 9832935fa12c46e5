"""Training loop of the port (twin of ``transoar_tpu/training/trainer.py``).

- ``derive_targets``: per-organ boxes from the segmentation batch, on the
  device (``utils/boxes.segmentation2bbox``).
- ``make_train_step``: undo the transfer compression; with
  ``augmentation.on_device: true`` the window and the augmentation on the
  card (``data/transforms.augment_batch``, draws from the step's
  generator), with host augmentation nothing (the host windowed the
  batch), else the intensity window (when the config has
  ``foreground_voxel_statistics``); then targets, forward
  (dropout masks from the step's generator), criterion, ``total_loss``,
  backward, global-norm clipping, then AdamW and the schedule (with
  ``trainer.grad_accum_steps`` k, on the mean gradient of k calls, every
  k-th call: ``train_state.UpdateRule``). With
  ``trainer.nan_guard: skip`` a non-finite loss drops the update, the
  moments and the step count (one host sync per step); ``error`` raises at
  the end of the epoch. Plain batching: ``trainer.microbatch``,
  ``steps_per_dispatch`` and ``xla_options`` are accepted and change
  nothing (on the JAX side they are TPU dispatch and layout choices whose
  equality with plain batching its tests pin). Under a torch profiler the
  step's phases are spans (``utils/spans.py``): ``step.inputs``
  (augmentation or window, targets, the sp scatter), ``step.forward``,
  ``step.criterion`` (with the normaliser's all-reduce, ``total_loss``),
  ``step.backward`` (``zero_grad``, the backward with the remat
  recompute) and ``step.update`` (the reported losses, the nan guard,
  clipping, AdamW, the schedule).
- ``make_eval_step``: the same up to the losses, without gradients; returns
  losses, predictions and targets. Validation decodes RetinaNet's
  predictions on the card (``models/retina.retina_inference`` with its
  defaults, as the JAX trainer), the others' on the host.
- ``Trainer``: with ``use_augmentation: true, on_device: false`` the train
  loader is wrapped in ``HostAugmentingLoader`` (``trainer.num_workers``
  threads, 8 if 0, with as many cases in flight beyond the batch handed
  out; ``_host_ahead=0`` keeps none, the JAX package's design, for
  measuring the two against each other); host batches compressed for the copy (image bf16 unless
  ``trainer.h2d_dtype`` or ``precision`` says f32, seg int8), copied from
  pinned memory on a copy stream, two batches ahead of the step, so the
  copies overlap the step on the compute stream; loss scalars stay on the
  device and are read once per epoch; validation with the evaluator, the
  best checkpoint on ``mAP_coco`` and ``model_last`` every epoch. Each
  epoch's history holds the train loop's wall time, loader included, and
  the volumes it stepped; ``Trainer.clock`` where the loop's time went.

Multi-GPU (a ``parallel.mesh.Layout``; the model wrapped by
``parallel.fsdp.parallelize``): each dp rank holds its rows of the global
batch. The criterion takes the global batch's normalizers
(``batch_normalizer`` all-reduced over dp) and the seg proxy's sums over
dp, so each rank's loss is its share of the global batch's loss; the
loss is scaled by dp before the backward, which undoes the gradient mean
of DDP / FSDP2, so the update is that of the global batch. The reported
losses are the shares summed over dp (one all-reduce a step), the
``nan_guard: skip`` decision is all-reduced over every rank, the
generator's seed folds in the dp index (``Layout.generator_seed``).
Validation runs on every rank over the whole val split, as the JAX
trainer; every rank makes the same best-checkpoint decision and the
checkpoints are gathered by all and written by rank 0. Under spatial
parallelism (``parallel/sp.py``) the sp ranks of one dp index hold the
same rows: each augments and windows them whole, derives the targets from
the whole segmentation, and hands the model its block of S0; the model's
outputs are whole, so the normalizers and the reported losses stay
all-reduced over dp alone (over dp x sp they would count sp times), and
every sp rank runs every validation batch, since the model's collectives
need all of them.

With ``grad_accum_steps`` > 1 the training checkpoints also hold the
accumulation's partial mean and its count (``checkpoints.py``), so a
resumed run updates where the uninterrupted one does.
"""

from __future__ import annotations

import collections
import logging
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from transoar_tpu_torch.data.transforms import (HostAugmentingLoader,
                                                 augment_batch,
                                                 eval_transform)
from transoar_tpu_torch.eval.evaluator import build_evaluator
from transoar_tpu_torch.models.criterion import build_criterion, total_loss
from transoar_tpu_torch.models.retina import retina_inference
from transoar_tpu_torch.parallel import sp as sp_lib
from transoar_tpu_torch.parallel.fsdp import unwrap
from transoar_tpu_torch.parallel.tp import tp_sharded
from transoar_tpu_torch.training import checkpoints as ckpt_lib
from transoar_tpu_torch.training.inference import inference
from transoar_tpu_torch.training.train_state import (UpdateRule,
                                                     current_lrs,
                                                     make_optimizer)
from transoar_tpu_torch.utils.boxes import segmentation2bbox
from transoar_tpu_torch.utils.spans import span

logger = logging.getLogger(__name__)

_PRED_KEYS = ("pred_logits", "pred_boxes", "anchor_logits", "anchor_deltas")


def derive_targets(seg, num_classes, bbox_padding=1):
    """Box targets of a label batch, on its device."""
    boxes, present = segmentation2bbox(seg, num_classes, padding=bbox_padding)
    return {"boxes": boxes, "present": present, "seg": seg}


def _augmentation_mode(config):
    """None, "host" or "device"."""
    aug = config.get("augmentation", {})
    if not aug.get("use_augmentation"):
        return None
    return "device" if aug.get("on_device", False) else "host"


def _prepare(batch, stats):
    """Undo the transfer compression; apply the intensity window."""
    image = batch["image"].float()
    if stats is not None:
        image = eval_transform(image, stats)
    return image, batch["seg"].long()


def _global_losses(losses, group):
    """The ranks' shares summed over ``group``: the global batch's losses
    (one all-reduce of the stacked scalars)."""
    stacked = torch.stack(list(losses.values()))
    dist.all_reduce(stacked, group=group)
    return dict(zip(losses, stacked.unbind()))


def _all_finite(loss, layout):
    """Whether ``loss`` is finite on every rank (one host sync)."""
    flag = torch.isfinite(loss).float()
    if layout is not None:
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def make_train_step(model, criterion, optimizer, scheduler, config,
                    generator=None, layout=None):
    """``step(batch) -> {loss name: device scalar}``; ``batch`` holds the
    device tensors ``image`` [B, S0, S1, S2, 1] and ``seg`` [B, S0, S1, S2]
    (a dp rank's rows under ``layout``, whole over S0). The step leaves the
    model's train/eval mode as it finds it; ``step.update`` is its
    ``UpdateRule``."""
    tcfg = config["trainer"]
    coefs = config["loss_coefs"]
    num_classes = config["neck"]["num_organs"]
    padding = config.get("bbox_padding", 1)
    stats = config.get("foreground_voxel_statistics")
    mode = _augmentation_mode(config)
    if mode == "device" and generator is None:
        raise ValueError("augmentation.on_device: true draws from the "
                         "step's generator: pass one")
    aug_cfg = config.get("augmentation", {})
    nan_guard = tcfg.get("nan_guard", "off")
    net = unwrap(model)
    trained = [(p, s) for p, s in zip(model.parameters(), tp_sharded(model))
               if p.requires_grad]
    update = UpdateRule(optimizer, scheduler, [p for p, _ in trained],
                        clip=tcfg.get("clip_max_norm", -1),
                        accum=tcfg.get("grad_accum_steps", 1),
                        layout=layout, sharded=[s for _, s in trained])
    group = None if layout is None else layout.dp_group
    sp = None if layout is None else layout.sp_shard

    def train_step(batch):
        with span("step.inputs"):
            if mode == "device":
                image, seg = augment_batch(batch["image"].float(),
                                           batch["seg"].long(), generator,
                                           aug_cfg, intensity_stats=stats)
            else:  # the host augmenter already windowed its batches
                image, seg = _prepare(batch,
                                      None if mode == "host" else stats)
            targets = derive_targets(seg, num_classes, padding)
            if sp is not None:
                image = sp_lib.scatter(image, sp)
        with span("step.forward"):
            out = model(image, generator=generator)
        with span("step.criterion"):
            if layout is None:
                losses = criterion(out, targets, net.anchors)
            else:
                norm = criterion.batch_normalizer(targets, net.anchors)
                dist.all_reduce(norm, group=group)
                losses = criterion(out, targets, net.anchors,
                                   present_total=norm, group=group)
            loss = total_loss(losses, coefs)
        with span("step.backward"):
            optimizer.zero_grad(set_to_none=True)
            (loss if layout is None else loss * layout.dp).backward()
        with span("step.update"):
            losses["total"] = loss
            losses = {k: v.detach() for k, v in losses.items()}
            if layout is not None:
                losses = _global_losses(losses, group)
            if nan_guard != "skip" or _all_finite(losses["total"], layout):
                update()
        return losses

    train_step.update = update
    return train_step


def make_eval_step(model, criterion, config, layout=None):
    """``step(batch) -> (losses, preds, targets)``, device tensors; under
    sp the model gets the rank's block of the whole batch."""
    coefs = config["loss_coefs"]
    num_classes = config["neck"]["num_organs"]
    padding = config.get("bbox_padding", 1)
    stats = config.get("foreground_voxel_statistics")
    net = unwrap(model)
    sp = None if layout is None else layout.sp_shard

    @torch.no_grad()
    def eval_step(batch):
        image, seg = _prepare(batch, stats)
        targets = derive_targets(seg, num_classes, padding)
        out = model(image if sp is None else sp_lib.scatter(image, sp))
        losses = criterion(out, targets, net.anchors)
        losses["total"] = total_loss(losses, coefs)
        return losses, {k: out[k] for k in _PRED_KEYS if k in out}, targets

    return eval_step


class _StepClock:
    """Where the train loop's time goes, step by step.

    ``ms``: each step's event time, CUDA events around it on the card (read
    after the epoch's one sync; they also hold any time the card waits for
    the host's enqueue, so they are no device busy time), the host clock
    on the CPU. On the host clock, for every device: ``start_s`` (when each
    step began), ``step_host_ms`` (the step's call), ``loader_ms`` (the
    loop waiting for each batch from its loader) and ``copy_ms`` (the
    batch's cast, pinning and copy enqueue)."""

    def __init__(self, device):
        self._cuda = device.type == "cuda"
        self._marks = []
        self.ms = []
        self.start_s, self.step_host_ms = [], []
        self.loader_ms, self.copy_ms = [], []

    def batch(self, asked, got, copied):
        """A batch's host times: asked the loader, got it, enqueued its
        copy (``time.perf_counter`` readings)."""
        self.loader_ms.append(1e3 * (got - asked))
        self.copy_ms.append(1e3 * (copied - got))

    def start(self):
        now = time.perf_counter()
        self.start_s.append(now)
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append([ev])
        else:
            self._marks.append([now])

    def stop(self):
        now = time.perf_counter()
        self.step_host_ms.append(1e3 * (now - self.start_s[-1]))
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks[-1].append(ev)
        else:
            self._marks[-1].append(now)

    def collect(self):
        """Move the finished steps' times into ``ms`` (after a sync)."""
        for a, b in self._marks:
            self.ms.append(a.elapsed_time(b) if self._cuda
                           else 1e3 * (b - a))
        self._marks = []


class Trainer:
    def __init__(self, config, model, train_loader, val_loader, path_to_run,
                 device="cuda", optimizer=None, scheduler=None,
                 start_epoch=0, metric_start_val=0.0, _host_ahead=None,
                 layout=None):
        self._config = config
        self._device = torch.device(device)
        self._model = model  # under DDP / FSDP2 with a layout
        self._layout = layout
        tcfg = config["trainer"]
        if _augmentation_mode(config) == "host":
            workers = int(tcfg.get("num_workers", 8) or 8)
            train_loader = HostAugmentingLoader(
                train_loader, config["augmentation"],
                intensity_stats=config.get("foreground_voxel_statistics"),
                seed=config.get("seed", 0), workers=workers,
                ahead=workers if _host_ahead is None else _host_ahead)
        self._train_loader = train_loader
        self._val_loader = val_loader
        self._path_to_run = Path(path_to_run)
        self._epoch_to_start = start_epoch
        self._metric_max_val = metric_start_val
        self._main_metric_key = "mAP_coco"
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
        seed = int(config.get("seed", 0))
        if layout is not None:
            seed = layout.generator_seed(seed)
        self._generator = torch.Generator(device=self._device).manual_seed(
            seed)
        self._copy_stream = (torch.cuda.Stream(self._device)
                             if self._device.type == "cuda" else None)

        self._criterion = criterion = build_criterion(config)
        self._evaluator = build_evaluator(config)
        self._train_step = make_train_step(model, criterion, optimizer,
                                           scheduler, config, self._generator,
                                           layout)
        self._eval_step = make_eval_step(model, criterion, config, layout)
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

    def _prefetch(self, loader, depth=3, clock=None):
        """Keep ``depth`` batches copied or in flight: the copies of the
        next two batches run on the copy stream beside the current step.
        ``clock`` gets each batch's host times."""
        buf = collections.deque()
        batches = iter(loader)
        while True:
            asked = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            got = time.perf_counter()
            buf.append(self._device_batch(batch))
            if clock is not None:
                clock.batch(asked, got, time.perf_counter())
            if len(buf) >= depth:
                yield self._ready(*buf.popleft())
        while buf:
            yield self._ready(*buf.popleft())

    # -- loops -------------------------------------------------------------
    def _train_one_epoch(self, epoch):
        self._model.train()
        step_losses, volumes = [], 0
        for device_batch in self._prefetch(self._train_loader,
                                           clock=self.clock):
            self.clock.start()
            step_losses.append(self._train_step(device_batch))
            self.clock.stop()
            volumes += device_batch["image"].shape[0] * (
                1 if self._layout is None else self._layout.dp)
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
            if "anchor_logits" in preds:  # RetinaNet: decoded on the card
                boxes, classes, scores = retina_inference(
                    preds, unwrap(self._model).anchors, num_organs)
            else:
                boxes, classes, scores = inference(
                    {k: v.cpu().numpy() for k, v in preds.items()},
                    num_organs)
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
                self.optimizer, self.scheduler, epoch, self._metric_max_val,
                self._layout, self._train_step.update)
        return means, metric_scores

    def resume(self, path):
        """Restore a training checkpoint into the model, the optimizer, the
        schedule and the accumulation, and start after its epoch; returns
        (epoch, best metric)."""
        epoch, best = ckpt_lib.restore_checkpoint(
            path, self._model, self.optimizer, self.scheduler, self._device,
            self._layout, self._train_step.update)
        self._epoch_to_start, self._metric_max_val = epoch, best
        return epoch, best

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
                    self._metric_max_val, self._layout,
                    self._train_step.update)
            self.history.append(record)
            logger.info("epoch %d done in %.1fs total_loss=%.4f mAP_coco=%s",
                        epoch, time.monotonic() - t0,
                        record["train"].get("total", float("nan")),
                        record.get("metrics", {}).get("mAP_coco"))
