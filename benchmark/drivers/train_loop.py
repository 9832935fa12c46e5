"""Driver ``train_loop``: the port's training loop as
``python -m transoar_tpu_torch.train`` runs it: the dataset's loader from
``data.dataset.get_loader`` (the native C++ reader at the config's
``num_workers``), ``training.trainer.Trainer`` with its host augmentation
(``data.transforms.HostAugmentingLoader`` on the config's threads, cases in
flight beyond the batch) and the pinned copies two batches ahead on a copy
stream, one ``Trainer._train_one_epoch`` call per epoch.

Set-up writes ``cases`` synthetic preprocessed cases at the config's patch
(CT-like f32 volumes in HU and int32 organ labels, ``data.npy`` /
``label.npy`` as the preprocessor writes them) under the run's scratch
directory, builds the model with the seeded weights, AdamW and the
Trainer. The loader the Trainer wraps is one stream of the native
loader's epochs, cycled: epoch 1 of the loop takes its first
``checked_steps + warmup_steps`` batches (the checked steps, then the
warm-up), epoch 2 is the window: it takes batches until ``--seconds``
have passed, then drains what is in flight, and ends with the loop's own
synchronize. Validation and checkpoints stay out, as they lie between
epochs. After the window the plain reference works the checked steps'
batches out again from the files (the loader's shuffle, the host
augmentation's draws: ``reference.augment``) and replays the steps.

Traffic keys: ``cases``, ``checked_steps``, ``warmup_steps``,
``steps_per_epoch``.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.counters import launch_counts
from benchmark.reference import augment, compare, runs, synthetic
from benchmark.reference import model as ref
from benchmark.reference.weights import make_weights


def write_dataset(cell, root):
    """``cases`` cases under ``root/<dataset>/train``; the split's path."""
    cfg = cell.config
    split = root / cfg["dataset"] / "train"
    patch = tuple(cfg["augmentation"]["patch_size"])
    for i in range(int(cell.traffic["cases"])):
        image, label = synthetic.ct_case(
            cfg, patch, synthetic.sub_seed(cell.seed, f"case{i}"),
            cell.device)
        case = split / f"case_{i:03d}"
        case.mkdir(parents=True)
        np.save(case / "data.npy", image)
        np.save(case / "label.npy", label)
    return split


class Stream:
    """The loader the Trainer wraps: the native loader's epochs as one
    stream. Each Trainer epoch takes ``take`` batches, or batches until
    ``until()`` says stop."""

    def __init__(self, loader):
        self.loader = loader
        self._stream = self._epochs()
        self.take, self.until = None, None

    def _epochs(self):
        while True:
            yield from self.loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        n = 0
        while (self.take is None or n < self.take) and \
                (self.until is None or not self.until()):
            yield next(self._stream)
            n += 1


class Observer:
    """Wraps the Trainer's step: keeps the first calls' readings (as
    ``train_step.Program.checked_steps``) and the parameters' change after
    them."""

    def __init__(self, step, model, optimizer, weights, steps, cls_coef):
        self.step, self.model, self.optimizer = step, model, optimizer
        self.weights, self.steps, self.cls_coef = weights, steps, cls_coef
        self.calls = 0
        self.readings = {"loss_cls": []}
        self.update = step.update

    def __call__(self, batch):
        out = self.step(batch)
        self.calls += 1
        if self.calls <= self.steps:
            self.readings["loss_cls"].append(
                self.cls_coef * sum(v.detach() for k, v in out.items()
                                    if k.split("_")[0] == "cls"))
            params = dict(self.model.named_parameters())
            if self.calls == 1:
                beta1 = self.optimizer.param_groups[0]["betas"][0]
                self.readings["grad1"] = {
                    n: float((self.optimizer.state[p]["exp_avg"]
                              / (1 - beta1)).norm())
                    if p in self.optimizer.state else 0.0
                    for n, p in params.items()}
            if self.calls == self.steps:
                self.delta = {n: p.detach() - self.weights[n]
                              for n, p in params.items()}
                self.readings["loss_cls"] = [float(v) for v in
                                             self.readings["loss_cls"]]
        return out


class Program:
    def __init__(self, cell):
        from transoar_tpu_torch.data.dataset import get_loader
        from transoar_tpu_torch.models.transoarnet import build_model
        from transoar_tpu_torch.training.train_state import make_optimizer
        from transoar_tpu_torch.training.trainer import Trainer

        cfg, t, dev = cell.config, cell.traffic, cell.device
        self.data_dir = cell.scratch / "dataset"
        self.split = write_dataset(cell, self.data_dir)
        self.weights = make_weights(ref.param_shapes(cfg),
                                    synthetic.sub_seed(cell.seed, "weights"),
                                    dev)
        self.model = build_model(cfg, device=dev)
        self.model.load_state_dict(self.weights)
        self.optimizer, scheduler = make_optimizer(
            self.model, cfg, int(t["steps_per_epoch"]))
        self.stream = Stream(get_loader(cfg, "train",
                                        data_dir=self.data_dir))
        self.trainer = Trainer(cfg, self.model, self.stream, None,
                               cell.scratch / "run", str(dev),
                               self.optimizer, scheduler)
        self.observer = Observer(self.trainer._train_step, self.model,
                                 self.optimizer, self.weights,
                                 int(t["checked_steps"]),
                                 float(cfg["loss_coefs"]["cls"]))
        self.trainer._train_step = self.observer

    def free(self):
        del self.trainer, self.model, self.optimizer, self.stream
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def reference_batches(cell, steps):
    """The first ``steps`` batches as the loop made them, worked out again
    from the files: the native loader's first epoch order, the host
    augmentation's per-case draws."""
    cfg = cell.config
    split = cell.scratch / "dataset" / cfg["dataset"] / "train"
    cases = sorted(p.name for p in split.iterdir() if p.is_dir())
    order = augment.epoch_order(len(cases), int(cfg.get("seed", 0)), 0)
    batch = int(cfg["trainer"]["batch_size"])
    out = []
    for step in range(steps):
        images, segs = [], []
        for index in order[step * batch:(step + 1) * batch]:
            image = np.load(split / cases[index] / "data.npy")
            label = np.load(split / cases[index] / "label.npy")
            seed = augment.case_seed(int(cfg.get("seed", 0)), 0, step,
                                     int(index))
            img, seg = augment.augment_case_np(
                image[..., None].astype(np.float32), label, seed,
                cfg["augmentation"], cfg.get("foreground_voxel_statistics"))
            images.append(img)
            segs.append(seg)
        out.append({"image": torch.as_tensor(np.stack(images),
                                             device=cell.device),
                    "seg": torch.as_tensor(np.stack(segs),
                                           device=cell.device)})
    return out


def reference(cell, program, steps, quant=None, moving=None):
    return runs.train(cell.config, program.weights,
                      reference_batches(cell, steps),
                      int(cell.config.get("seed", 0)), cell.device, quant,
                      moving)


def compared(program, ref_out):
    obs = program.observer
    got = dict(obs.readings, change=runs.masked_norms(obs.delta,
                                                      ref_out["moving"]))
    return compare.train_readings(got, ref_out)


def run(cell) -> harness.Outcome:
    t = cell.traffic
    steps = int(t["checked_steps"])
    prog = Program(cell)
    prog.stream.take = steps + int(t["warmup_steps"])
    prog.trainer._train_one_epoch(1)
    clock = prog.trainer.clock
    marks = (len(clock.loader_ms), len(prog.trainer._train_loader.case_ms))
    prog.stream.take = None
    before = launch_counts()
    with harness.Window(cell.device, cell.trace) as window:
        prog.stream.until = lambda: window.elapsed() >= cell.seconds
        with harness.span("epoch"):
            _, volumes = prog.trainer._train_one_epoch(2)
    after = launch_counts()
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    setup_s = window.t0 - cell.t_start
    counters = {
        "steps": volumes // int(cell.config["trainer"]["batch_size"]),
        "volumes": volumes,
        "loader_ms": clock.loader_ms[marks[0]:],
        "case_ms": prog.trainer._train_loader.case_ms[marks[1]:],
        "launches": {k: after[k] - before[k] for k in after}}
    prog.free()

    t0 = time.perf_counter()
    ref_out = reference(cell, prog, steps)
    harness.note(f"reference in {time.perf_counter() - t0:.1f} s")
    values, where = compared(prog, ref_out)
    for k, leaf in where.items():
        harness.note(f"{k}: worst leaf {leaf}")
    harness.note(f"{volumes} volumes in {window.seconds:.3f} s; median "
                 f"case {statistics.median(counters['case_ms']):.1f} ms")
    return harness.Outcome(
        attempted=counters["steps"], failed=0,
        e2e={"setup_s": setup_s,
             "train_volumes_per_s": volumes / window.seconds},
        checks=harness.checks(values, cell.limits),
        counters=counters, window=window, memory_peak_bytes=peak)


def readings(cell, control: bool) -> dict:
    """The check's readings of one seed: the loop's checked steps (no
    window) against the reference, and the control's with ``control``."""
    from benchmark.reference.quant import fp8

    steps = int(cell.traffic["checked_steps"])
    prog = Program(cell)
    prog.stream.take = steps
    prog.trainer._train_one_epoch(1)
    prog.free()
    ref_out = reference(cell, prog, steps)
    out = {"program": compared(prog, ref_out)}
    if control:
        ctl = reference(cell, prog, steps, quant=fp8,
                        moving=ref_out["moving"])
        out["control"] = compare.train_readings(ctl, ref_out)
    return out
