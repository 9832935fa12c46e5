"""Driver ``serve_predict``: served requests, NIfTI file to detections,
through the port's serving entry (``predict.load_predictor`` once, then
``predict.predict_case`` per request: NIfTI decode, RAS reorientation,
resize, intensity window, forward on the card, per-organ decode).

Set-up writes the run directory (the port's checkpoint of the seeded
weights and the frozen config) and the pool of CT volumes (``pool_slices``
slices of ``in_plane`` voxels at ``spacing_mm``, int16 LPS ``.nii.gz`` at
gzip level 1) under the run's scratch directory, loads the predictor and
serves ``warmup_requests`` requests. The window is an open loop: request
``i`` is due ``i / rate_per_s`` seconds after the start, for every ``i``
due before ``--seconds``; one server takes them in order, at once when
late, and a request's latency runs from when it was due to its detections
in hand. Every block of ``len(pool)`` requests visits each volume once, in
an order drawn from the seed. After the window the predictor is freed and
the plain reference serves one request of each volume (drawn from the
seed) from the same files and weights; the comparison is at the query the
program's own outputs rank first for each organ.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import compare, nifti, runs, synthetic
from benchmark.reference import model as ref
from benchmark.reference.weights import make_weights


def write_pool(cell, folder):
    """The request volumes; their paths, in pool order."""
    t = cell.traffic
    folder.mkdir(parents=True, exist_ok=True)
    sx, sy, sz = t["spacing_mm"]
    paths = []
    for i, slices in enumerate(t["pool_slices"]):
        vol = synthetic.ct_volume((*t["in_plane"], slices),
                                  synthetic.sub_seed(cell.seed, f"ct{i}"),
                                  cell.device)
        affine = np.diag([-sx, -sy, sz, 1.0])
        affine[:3, 3] = (120.0, 110.0, -150.0 + 10 * i)
        path = folder / f"case{i}.nii.gz"
        nifti.write_nifti(vol, path, affine=affine, level=1)
        paths.append(str(path))
    return paths


def order(cell, n_pool, count):
    """Pool index of each request: a seeded permutation per block."""
    rng = np.random.default_rng(synthetic.sub_seed(cell.seed, "order"))
    blocks = -(-count // n_pool)
    return np.concatenate([rng.permutation(n_pool)
                           for _ in range(blocks)])[:count].tolist()


class Program:
    """The served system: the predictor loaded from a run directory of the
    seeded weights."""

    def __init__(self, cell):
        from transoar_tpu_torch import predict
        from transoar_tpu_torch.models.transoarnet import build_model
        from transoar_tpu_torch.training import checkpoints

        cfg, dev = cell.config, cell.device
        self.predict = predict
        self.weights = make_weights(ref.param_shapes(cfg),
                                    synthetic.sub_seed(cell.seed, "weights"),
                                    dev)
        run_dir = cell.scratch / "run"
        model = build_model(cfg, device=dev)
        model.load_state_dict(self.weights)
        checkpoints.freeze_run_config(cfg, run_dir)
        checkpoints.save_checkpoint(run_dir, "model_last", model)
        del model
        self.paths = write_pool(cell, cell.scratch / "volumes")
        self.config, _, self.forward = predict.load_predictor(
            run_dir, device=str(dev))
        self.raw = None

    def _forward(self, image):
        out = self.forward(image)
        self.raw = out
        return out

    def __call__(self, path):
        """(service seconds, forward seconds, the answer for the check)."""
        t0 = time.perf_counter()
        dets, _, _, _, fwd_s = self.predict.predict_case(
            path, self.config, self._forward)
        service = time.perf_counter() - t0
        organs = self.config["neck"]["num_organs"]
        logits = self.raw["pred_logits"][0, :, 0].astype(np.float64)
        pick = logits.reshape(organs, -1).argmax(-1)
        answer = {
            "pick": pick,
            "scores": np.array([d["score"] for d in dets]),
            "boxes": np.array([d["box_cxcyczwhd_norm"] for d in dets]),
            "world": np.array([d["world_mm_lo"] + d["world_mm_hi"]
                               for d in dets])}
        return service, fwd_s, answer

    def free(self):
        del self.forward, self.predict
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def run(cell) -> harness.Outcome:
    t = cell.traffic
    prog = Program(cell)
    for i in range(int(t["warmup_requests"])):
        prog(prog.paths[i % len(prog.paths)])
    rate = float(t["rate_per_s"])
    count = max(int(rate * cell.seconds), 1)
    which = order(cell, len(prog.paths), count)
    latency, service, forward, answers, failed = [], [], [], {}, 0
    with harness.Window(cell.device, cell.trace) as window:
        for i, k in enumerate(which):
            due = i / rate
            wait = due - window.elapsed()
            if wait > 0:
                time.sleep(wait)
            try:
                with harness.span("request"):
                    s, f, answer = prog(prog.paths[k])
            except Exception as err:  # a failed request misses every limit
                harness.note(f"request {i} failed: {err!r}")
                failed += 1
                continue
            latency.append(window.elapsed() - due)
            service.append(s)
            forward.append(f)
            answers.setdefault(k, []).append(answer)
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    setup_s = window.t0 - cell.t_start
    prog.free()

    rng = np.random.default_rng(synthetic.sub_seed(cell.seed, "sample"))
    sample = sorted(answers)
    picked = [answers[k][rng.integers(len(answers[k]))] for k in sample]
    t0 = time.perf_counter()
    ref_out = runs.serve(cell.config, prog.weights,
                         [prog.paths[k] for k in sample], cell.device)
    harness.note(f"reference in {time.perf_counter() - t0:.1f} s")
    values = compare.serve_readings(picked, ref_out)
    checks = harness.checks(values, cell.limits)
    e2e = {"setup_s": setup_s}
    if latency:
        e2e["serve_latency_p50_ms"] = 1e3 * statistics.median(latency)
    harness.note(f"{count} requests due, {len(latency)} served, service "
                 f"s median {statistics.median(service) if service else 0}")
    return harness.Outcome(
        attempted=count, failed=failed, e2e=e2e, checks=checks,
        counters={"served": len(latency), "forward_s": forward,
                  "service_s": service, "latency_s": latency},
        window=window, memory_peak_bytes=peak)


def readings(cell, control: bool) -> dict:
    """The check's readings of one seed without a window: one request of
    each pool volume by the program and, with ``control``, by the
    reference in fp8 in its place."""
    from benchmark.reference.quant import fp8

    prog = Program(cell)
    answers = [prog(path)[2] for path in prog.paths]
    prog.free()
    ref_out = runs.serve(cell.config, prog.weights, prog.paths, cell.device)
    out = {"program": (compare.serve_readings(answers, ref_out), {})}
    if control:
        ctl = runs.serve(cell.config, prog.weights, prog.paths, cell.device,
                         quant=fp8)
        organs = cell.config["neck"]["num_organs"]
        answers = [control_answer(c, organs) for c in ctl]
        out["control"] = (compare.serve_readings(answers, ref_out), {})
    return out


def control_answer(ctl, organs):
    """The control's served answer: each organ's first-ranked query."""
    o = np.arange(organs)
    pick = ctl["probs"].argmax(-1)
    return {"pick": pick, "scores": ctl["probs"][o, pick],
            "boxes": ctl["boxes"][o, pick], "world": ctl["world"][o, pick]}
