"""CPU rehearsal of the refine cell (``foc_dec_refine_amos.train_step``,
driver ``train_step_refine``): its configuration against the flagship's,
the driver and every reader the cell reports at a tiny size, traced; the
readers of the deformable sampling on a made-up trace; the model FLOPs
with the refine; the faults turning ``correct`` false, a sampling fault
planted here among them (the coordinate order swapped inside the port's
``ms_deform_attn``); the control failing the limits where the program
passes.

Run: ``python -m pytest -q benchmark/``. The ``cuda`` case runs at the
cell's own size and skips without a card: the share of the seeded
samples that land inside their level, the program passing and the
control failing the limits, and the planted sampling fault failing one:
``python -m pytest -q -m cuda benchmark/test_bench_refine.py`` on a
machine with one.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import faults, harness
from benchmark.reference import refine, refine_work, work

ROOT = harness.ROOT
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
CELL = "foc_dec_refine_amos.train_step"
STATS = {"percentile_00_5": -100.0, "percentile_99_5": 300.0, "mean": 80.0,
         "std": 75.0}


def _config(name):
    return harness.load_json(ROOT / f"benchmark/configs/{name}.json")[
        "config"]


def test_config_is_the_flagship_with_the_refine():
    got, want = _config("foc_dec_refine_amos"), _config("foc_dec_amos")
    assert got["backbone"].pop("use_decoder_attn") is True
    want["backbone"].pop("use_decoder_attn")
    assert got.pop("experiment_name") == "foc_dec_refine_amos"
    want.pop("experiment_name")
    assert got == want
    da = got["backbone"]["def_attn"]
    assert (da["feature_levels"], da["hidden_dim"], da["nheads"],
            da["n_points"], da["layers"], da["dim_feedforward"]) == (
        ["P3", "P4", "P5"], 384, 6, 4, 2, 1024)
    assert refine.level_shapes(got) == [(32, 32, 16), (16, 16, 8), (8, 8, 4)]


def test_model_flops_count_the_refine():
    """The refine cell's FLOPs less the flagship's: the refine's linears
    (value, offsets, weights, output, FFN) over 18,688 tokens a volume and
    the FPN's 3x3x3 output convs at P4 and P5, forward and backward (3x)."""
    cfg = _config("foc_dec_refine_amos")
    extra = refine_work.model_flops(cfg, 1, True) \
        - work.model_flops(_config("foc_dec_amos"), 1, True)
    C, tokens = 384, 32 * 32 * 16 + 16 * 16 * 8 + 8 * 8 * 4
    linears = 2 * 2 * tokens * C * (C + 6 * 3 * 4 * 3 + 6 * 3 * 4 + C
                                    + 2 * 1024)
    convs = 2 * (16 * 16 * 8 + 8 * 8 * 4) * 27 * C * C
    assert extra == pytest.approx(3 * (linears + convs), rel=0.02)
    assert refine_work.model_flops(cfg, 2, True) \
        == 2 * refine_work.model_flops(cfg, 1, True)


def _reading(cfg, counters, ops, seconds=1.0):
    cell = harness.Cell(CELL, cfg, {}, {}, 0, seconds, True, 1)
    win = harness.Window(torch.device("cpu"), True)
    win.seconds = seconds
    win.trace = harness.TraceSummary(sorted(ops, key=lambda o: o[1]),
                                     (0, 10**9), [], [])
    return harness.Reading(cell, harness.Outcome(1, 0, {}, [], counters,
                                                 window=win))


def _reader(name):
    return harness.load_module(harness.metric_file(name), "reader_" + name)


def test_sampling_readers_read_bound_over_kernel_time():
    cfg = _config("foc_dec_refine_amos")
    b = refine_work.sampling_bounds(cfg)
    assert b["samples"] == 2 * 18688 * 6 * 3 * 4
    need = 4 * (b["fwd"] + b["bwd"])
    ops = [("void at::native::(anonymous namespace)::grid_sampler_3d_kernel"
            "<float, long>(long, x)", 0, int(need * 1e9)),
           ("void at::native::(anonymous namespace)::grid_sampler_3d_"
            "backward_kernel<float, long>(long, x)", 0, int(need * 1e9)),
           ("ampere_sgemm", 0, 10**6)]
    counters = {"steps": 2,
                "launches": {"deform_calls": 4,
                             "deform_samples": 4 * b["samples"]},
                "deform_kernels": ("grid_sampler_3d_kernel",
                                   "grid_sampler_3d_backward_kernel")}
    roofline, sample_ms = _reader("def_attn_roofline"), \
        _reader("refine.sample_ms.train")
    assert roofline.read(_reading(cfg, counters, ops)) \
        == pytest.approx(50.0, rel=1e-4)
    assert sample_ms.read(_reading(cfg, counters, ops)) \
        == pytest.approx(1e3 * need, rel=1e-4)
    # another shape than the cell's, or a port without the counters
    odd = dict(counters, launches={"deform_calls": 4, "deform_samples": 4})
    assert roofline.read(_reading(cfg, odd, ops)) is None
    bare = {"steps": 2, "launches": {"band_fwd": 4}}
    for reader in (roofline, sample_ms):
        assert reader.read(_reading(cfg, bare, ops)) is None


def _cell(tmp_path, seed=2 ** 31 + 11, trace=False):
    from transoar_tpu_torch import presets

    cfg = presets.tiny_config("refine")
    cfg["trainer"]["batch_size"] = 2
    cfg["foreground_voxel_statistics"] = dict(STATS)
    return harness.Cell(CELL, cfg, {}, harness.resolve(BENCH, CELL)[
        "traffic"], seed, 0.3, trace, 1, device=torch.device("cpu"),
        t_start=time.perf_counter(), scratch=tmp_path,
        limits=harness.limits(CELL))


def _driver():
    return harness.load_module(harness.resolve(BENCH, CELL)["driver"],
                               "driver_refine")


def _correct(outcome):
    return outcome.failed == 0 and all(v <= lim for _, v, lim in
                                       outcome.checks)


def test_driver_runs_on_cpu_and_readers_read(tmp_path):
    cell = _cell(tmp_path, trace=True)
    outcome = _driver().run(cell)
    assert outcome.failed == 0 and outcome.attempted >= 1
    assert _correct(outcome), outcome.checks
    assert {name for name, _, _ in outcome.checks} == set(cell.limits)
    launches = outcome.counters["launches"]
    per_call = refine_work.sampling_bounds(cell.config)["samples"]
    # two layers a step
    assert launches["deform_calls"] == 2 * outcome.counters["steps"]
    assert launches["deform_samples"] == launches["deform_calls"] * per_call
    reading = harness.Reading(cell, outcome)
    values = {m["name"]: _reader(m["name"]).read(reading)
              for m in harness.metrics_of(BENCH, CELL, True)}
    assert {"mfu.refine.train", "def_attn_roofline",
            "refine.forward_ms.train", "refine.sample_ms.train"} <= set(
        values)
    assert all(v is None or v >= 0 for v in values.values()), values
    assert values["mfu.refine.train"] > 0


def _swapped_coordinates(monkeypatch):
    """The port's sampling with the coordinate order reversed (coordinate
    0 read as the first axis)."""
    from transoar_tpu_torch.ops import deformable_attention as da

    sample = da._sample
    monkeypatch.setattr(da, "_sample", lambda value, shapes, loc, weights:
                        sample(value, shapes, loc.flip(-1), weights))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "swapped_coordinates"])
def test_fault_in_the_timed_path_is_not_correct(fault, tmp_path,
                                                monkeypatch):
    cell = _cell(tmp_path)
    if fault == "swapped_coordinates":
        _swapped_coordinates(monkeypatch)
        assert not _correct(_driver().run(cell))
        return
    with faults.planted(fault):
        assert not _correct(_driver().run(cell))


def test_control_fails_and_the_program_passes_at_a_tiny_size(tmp_path):
    cell = _cell(tmp_path, seed=2 ** 31 + 21)
    got = _driver().readings(cell, control=True)
    program, _ = got["program"]
    control, _ = got["control"]
    limits = cell.limits
    assert all(v <= limits[k] for k, v in program.items() if k in limits), \
        program
    assert any(v > limits[k] for k, v in control.items() if k in limits), \
        control


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_sampling_at_the_cells_size(card, tmp_path, monkeypatch):
    """At the cell's own size on one seed: the share of the seeded samples
    that land inside their level (every coordinate in [0, 1]), per level,
    printed and at least half; the program passes the cell's limits and
    the control (the reference in fp8 in its place) fails one of them;
    then the planted sampling fault fails one. Only the compared readings
    are held to the limits: ``loss_cls.step2`` / ``.step3`` are printed,
    not compared (``PERF.md`` §2)."""
    from transoar_tpu_torch.ops import deformable_attention as da

    found = harness.resolve(BENCH, CELL)
    config_file = harness.load_json(found["config_file"])
    cell = harness.Cell(CELL, json.loads(json.dumps(config_file["config"])),
                        config_file, found["traffic"], 2 ** 31 + 301, 0.0,
                        False, 1, device=card, scratch=tmp_path,
                        limits=harness.limits(CELL))
    inside = []
    sample = da._sample

    def counted(value, shapes, loc, weights):
        if len(inside) < 2:  # the first step's two layers
            ok = ((loc >= 0) & (loc <= 1)).all(-1)  # [B, Q, M, L, P]
            inside.append(ok.float().mean((0, 1, 2, 4)).tolist())
        return sample(value, shapes, loc, weights)

    with monkeypatch.context() as m:
        m.setattr(da, "_sample", counted)
        got = _driver().readings(cell, control=True)
    print(f"inside their level, per layer and level "
          f"(P3, P4, P5): {inside}")
    assert len(inside) == 2 and all(s >= 0.5 for row in inside
                                    for s in row), inside
    limits = cell.limits

    def fails(values):
        return any(v > limits[k] for k, v in values.items() if k in limits)

    program, control = got["program"][0], got["control"][0]
    print(f"program {program}\ncontrol {control}")
    assert not fails(program) and fails(control), (program, control)
    _swapped_coordinates(monkeypatch)
    values, _ = _driver().readings(cell, control=False)["program"]
    print(f"swapped coordinates {values}")
    assert fails(values), values
