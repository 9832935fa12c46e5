"""Driver ``train_step``: the port's train step
(``training.trainer.make_train_step``) in a closed loop, whole steps back
to back, on a pool of seeded batches resident on the card, used in turn.

Set-up builds the one step object: the model (``build_model``) with the
seeded weights (``reference.weights``), AdamW and the schedule
(``make_optimizer``), the step with its dropout generator. Its first
``checked_steps`` calls, on pool batches that all differ, are the checked
steps: the classification loss of each, the first gradient (AdamW's first
moment) and the parameters' change after them are kept. ``warmup_steps`` more calls, then
the window: steps until ``--seconds`` have passed on the host, then a
synchronize; the window is the CUDA-event time of every step it holds.
After it the program is freed and the plain reference replays the checked
steps from the same weights, batches and dropout seed.

Traffic keys: ``pool_batches``, ``checked_steps``, ``warmup_steps``,
``steps_per_epoch`` (the schedule's, as a 200-case split at batch 2).
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import harness
from benchmark.counters import launch_counts
from benchmark.reference import compare, runs, synthetic
from benchmark.reference import model as ref
from benchmark.reference.weights import make_weights




def classification_loss(losses: dict):
    """The unweighted sum of a step's classification losses, final and
    auxiliary (``cls``, ``cls_<i>``)."""
    return sum(v.detach() for k, v in losses.items()
               if k.split("_")[0] == "cls")


class Program:
    """The step object the window drives, built from the cell's seed.
    After the checked steps ``delta`` holds each parameter's change, kept
    on the card until the reference says which elements to compare."""

    def __init__(self, cell):
        from transoar_tpu_torch.models.criterion import build_criterion
        from transoar_tpu_torch.models.transoarnet import build_model
        from transoar_tpu_torch.training.train_state import make_optimizer
        from transoar_tpu_torch.training.trainer import make_train_step

        cfg, t, dev = cell.config, cell.traffic, cell.device
        self.config = cfg
        self.weights = make_weights(ref.param_shapes(cfg),
                                    synthetic.sub_seed(cell.seed, "weights"),
                                    dev)
        self.model = build_model(cfg, device=dev)
        self.model.load_state_dict(self.weights)
        self.model.train()
        self.optimizer, scheduler = make_optimizer(
            self.model, cfg, int(t["steps_per_epoch"]))
        self.dropout_seed = synthetic.sub_seed(cell.seed, "dropout")
        self.step = make_train_step(
            self.model, build_criterion(cfg), self.optimizer, scheduler, cfg,
            torch.Generator(device=dev).manual_seed(self.dropout_seed))
        self.pool = synthetic.train_batches(
            cfg, int(t["pool_batches"]), synthetic.sub_seed(cell.seed,
                                                            "data"), dev)
        self.calls = 0

    def __call__(self):
        out = self.step(self.pool[self.calls % len(self.pool)])
        self.calls += 1
        return out

    def checked_steps(self, steps: int) -> dict:
        """Run the first ``steps`` calls; the readings the check compares."""
        params = dict(self.model.named_parameters())
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        out = {"loss_cls": []}
        coef = float(self.config["loss_coefs"]["cls"])
        for i in range(steps):
            out["loss_cls"].append(coef * classification_loss(self()))
            if i == 0:
                out["grad1"] = {}
                for n, p in params.items():
                    m = self.optimizer.state.get(p, {}).get("exp_avg")
                    out["grad1"][n] = (m / (1 - beta1)).norm() \
                        if m is not None else torch.zeros(())
        self.delta = {n: p.detach() - self.weights[n]
                      for n, p in params.items()}
        out["loss_cls"] = [float(v) for v in out["loss_cls"]]
        out["grad1"] = {n: float(v) for n, v in out["grad1"].items()}
        return out

    def free(self):
        """Drop everything but the weights and the checked batches."""
        del self.model, self.optimizer, self.step
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def reference(cell, program, steps, quant=None, moving=None) -> dict:
    return runs.train(cell.config, program.weights, program.pool[:steps],
                      program.dropout_seed, cell.device, quant, moving)


def compared(program, got, ref_out):
    """The program's readings against the reference's: its change over the
    elements the reference's step-1 gradient moves."""
    got = dict(got, change=runs.masked_norms(program.delta,
                                             ref_out["moving"]))
    return compare.train_readings(got, ref_out)


def run(cell) -> harness.Outcome:
    t = cell.traffic
    steps, warmup = int(t["checked_steps"]), int(t["warmup_steps"])
    prog = Program(cell)
    readings = prog.checked_steps(steps)
    for _ in range(warmup):
        prog()
    before = launch_counts()
    with harness.Window(cell.device, cell.trace) as window:
        calls = 0
        while calls == 0 or window.elapsed() < cell.seconds:
            with harness.span("step"):
                prog()
            calls += 1
    after = launch_counts()
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    setup_s = window.t0 - cell.t_start
    batch = int(cell.config["trainer"]["batch_size"])
    prog.free()

    t0 = time.perf_counter()
    ref_out = reference(cell, prog, steps)
    harness.note(f"reference in {time.perf_counter() - t0:.1f} s")
    values, where = compared(prog, readings, ref_out)
    for k, leaf in where.items():
        harness.note(f"{k}: worst leaf {leaf}")
    return harness.Outcome(
        attempted=calls, failed=0,
        e2e={"setup_s": setup_s,
             "train_volumes_per_s": calls * batch / window.seconds},
        checks=harness.checks(values, cell.limits),
        counters={"steps": calls, "volumes": calls * batch,
                  "launches": {k: after[k] - before[k] for k in after}},
        window=window, memory_peak_bytes=peak)


def readings(cell, control: bool) -> dict:
    """The check's readings of one seed without a window: the program's,
    and with ``control`` those of the reference in fp8 in its place."""
    from benchmark.reference.quant import fp8

    steps = int(cell.traffic["checked_steps"])
    prog = Program(cell)
    got = prog.checked_steps(steps)
    prog.free()
    ref_out = reference(cell, prog, steps)
    out = {"program": compared(prog, got, ref_out)}
    if control:
        ctl = reference(cell, prog, steps, quant=fp8,
                        moving=ref_out["moving"])
        out["control"] = compare.train_readings(ctl, ref_out)
    return out
