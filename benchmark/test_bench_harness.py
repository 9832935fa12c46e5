"""CPU rehearsal of the benchmark: ``BENCHMARK.json`` against the
contract's shape and its files by name; a new cell, configuration,
traffic mix and per-layer metric added as new files only; every driver
and per-layer reader at tiny sizes on the CPU (the port's kernels run
their plain versions there); the faults each cell can have turning
``correct`` false; the control failing the limits; no result without a
card.

Run: ``python -m pytest -q benchmark/`` (the repository's ``tests/`` run
does not collect this folder). Tests marked ``cuda`` run the control at
the cell's own size and skip without a card:
``python -m pytest -q -m cuda benchmark/`` on a machine with one.
"""

from __future__ import annotations

import copy
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import faults, harness
from benchmark.reference import work

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.load_json(ROOT / "BENCHMARK.json")


# ---------------------------------------------------------------------------
# BENCHMARK.json and its files
# ---------------------------------------------------------------------------

def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] \
            + [c["source"] for c in BENCH["configs"]] \
            + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_resolve_by_name(cell):
    found = harness.resolve(BENCH, cell)
    assert found["config_file"].exists() and found["driver"].exists()
    config_file = harness.load_json(found["config_file"])
    assert {"source", "reduced", "assumed", "config"} <= set(config_file)
    limits = harness.limits(cell)
    assert limits and all(isinstance(v, (int, float))
                          for v in limits.values())
    e2e = {m["name"] for m in harness.metrics_of(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.metrics_of(BENCH, cell, True)
    assert per_layer
    for m in per_layer:
        assert harness.metric_file(m["name"]).exists()
        assert m["moves"] in e2e  # the metric it moves is reported here


def test_same_layer_same_name():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    text = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in text, layer


def _digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_config_traffic_and_metric_are_new_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "benchmark")
    bench = copy.deepcopy(BENCH)
    conf = harness.load_json(ROOT / "benchmark/configs/foc_dec_amos.json")
    conf["name"] = "dummy"
    (tmp_path / "benchmark/configs/dummy.json").write_text(json.dumps(conf))
    traffic = harness.load_json(ROOT / "benchmark/traffic/train_step_b2.json")
    traffic["pool_batches"] = 2
    (tmp_path / "benchmark/traffic/dummy_mix.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark/limits/dummy.cell.json").write_text(
        json.dumps({"limits": {"loss.step1": 0.5}}))
    (tmp_path / "benchmark/metrics/dummy.steps.py").write_text(
        "def read(r):\n    return float(r.counters['steps'])\n")
    bench["configs"].append({"name": "dummy", "source": "x",
                             "file": "benchmark/configs/dummy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "dummy.steps", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "train_volumes_per_s",
                               "workloads": ["dummy.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_volumes_per_s":
            m["workloads"].append("dummy.cell")
    found = harness.resolve(bench, "dummy.cell", root=tmp_path)
    assert found["traffic"]["pool_batches"] == 2
    assert found["driver"].name == "train_step.py"
    assert harness.limits("dummy.cell", root=tmp_path) == {"loss.step1": 0.5}
    names = [m["name"] for m in harness.metrics_of(bench, "dummy.cell",
                                                   True)]
    assert names == ["dummy.steps"]
    reader = harness.load_module(
        harness.metric_file("dummy.steps", root=tmp_path), "dummy_reader")
    outcome = harness.Outcome(1, 0, {}, [], {"steps": 7})
    assert reader.read(harness.Reading(None, outcome)) == 7.0
    after = _digest(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


# ---------------------------------------------------------------------------
# readers and the trace
# ---------------------------------------------------------------------------

def test_kernel_function_names():
    f = harness.kernel_function
    assert f("void (anonymous namespace)::conv_wide<96>(CUtensorMap)") \
        == "conv_wide"
    assert f("void (anonymous namespace)::dw_reduce(float const*)") \
        == "dw_reduce"
    assert f("sm90_xmma_gemm_bf16bf16_bf16f32") \
        == "sm90_xmma_gemm_bf16bf16_bf16f32"


def _trace(ops, window=(0, 1_000_000_000), spans=()):
    return harness.TraceSummary(sorted(ops, key=lambda o: o[1]), window, [],
                                list(spans))


def test_busy_is_the_union_of_overlapping_streams():
    t = _trace([("a", 0, 400_000_000), ("b", 100_000_000, 300_000_000),
                ("c", 600_000_000, 700_000_000)],
               spans=[("bench.step", 0, 1_000_000_000)])
    assert t.busy_s == pytest.approx(0.5)
    gaps = t.idle_gaps()
    assert gaps[0][0] == "bench.step" and gaps[0][1] == pytest.approx(0.5)
    assert t.top_ops()[0] == ["a", 0.4]


def _reading(cfg, counters, ops, seconds=1.0, window_ns=10**9):
    cell = harness.Cell("x", cfg, {}, {}, 0, seconds, True, 1)
    win = harness.Window(torch.device("cpu"), True)
    win.seconds = seconds
    win.trace = _trace(ops, (0, window_ns))
    return harness.Reading(cell, harness.Outcome(1, 0, {}, [], counters,
                                                 window=win))


def _config(name):
    return harness.load_json(ROOT / f"benchmark/configs/{name}.json")[
        "config"]


def test_band_conv_roofline_reads_bound_over_kernel_time():
    cfg = _config("foc_dec_amos")
    bounds = work.band_conv_bounds(cfg)
    need = bounds["fwd"] * 2 + bounds["dx"] + bounds["dw"]
    ops = [("void (anonymous namespace)::conv_wide<96>(x)", 0,
            int(2 * need * 1e9)), ("ampere_gemm", 0, 10)]
    launches = {"band_fwd": 4, "band_dx": 1, "band_dw": 2}
    reader = harness.load_module(harness.metric_file("band_conv_roofline"),
                                 "band")
    assert reader.read(_reading(cfg, {"launches": launches}, ops)) \
        == pytest.approx(50.0, rel=1e-6)
    assert reader.read(_reading(cfg, {"launches": launches}, [])) is None


def test_window_roofline_is_silent_without_swin():
    reader = harness.load_module(harness.metric_file("window_attn_roofline"),
                                 "window")
    ops = [("void (anonymous namespace)::fwd_wg(x)", 0, 10**6)]
    counters = {"launches": {"window_fwd": 8, "window_bwd": 8}}
    assert reader.read(_reading(_config("foc_dec_amos"), counters, ops)) \
        is None
    assert reader.read(_reading(_config("swin_fpn_visceral"), counters,
                                ops)) > 0


def test_model_flops_count_the_conv_not_the_band():
    cfg = _config("foc_dec_amos")
    per_volume = work.model_flops(cfg, 1, True)
    assert 2.0e12 < per_volume < 2.7e12
    assert work.model_flops(cfg, 2, True) == 2 * per_volume


# ---------------------------------------------------------------------------
# drivers at tiny sizes on the CPU, the faults, the control
# ---------------------------------------------------------------------------

STATS = {"percentile_00_5": -100.0, "percentile_99_5": 300.0, "mean": 80.0,
         "std": 75.0}


def _tiny(kind):
    from transoar_tpu_torch import presets

    cfg = presets.tiny_swin_config() if kind == "swin" \
        else presets.tiny_flagship_config()
    cfg["trainer"]["batch_size"] = 2
    cfg["foreground_voxel_statistics"] = dict(STATS)
    return cfg


def _cell(kind, tmp_path, seed=2 ** 31 + 11, seconds=0.3, trace=False):
    if kind == "loop":  # a driver whose cell waits (PERF.md §7 a)
        cell = harness.Cell(
            "foc_dec_amos.train_loop", _tiny("flagship"), {},
            dict(harness.load_json(
                ROOT / "benchmark/traffic/train_loop_host_aug.json"),
                cases=8), seed, seconds, trace, 1,
            device=torch.device("cpu"), t_start=time.perf_counter(),
            scratch=tmp_path, limits={})
        cell.driver = ROOT / "benchmark/drivers/train_loop.py"
        return cell
    if kind == "serve":
        workload = "foc_dec_amos.serve"
        traffic = dict(harness.resolve(BENCH, workload)["traffic"],
                       in_plane=[48, 40], pool_slices=[20, 24],
                       rate_per_s=8.0, warmup_requests=1)
        cfg = _tiny("flagship")
    else:
        workload = ("swin_fpn_visceral" if kind == "swin"
                    else "foc_dec_amos") + ".train_step"
        traffic = harness.resolve(BENCH, workload)["traffic"]
        cfg = _tiny(kind)
    return harness.Cell(workload, cfg, {}, traffic, seed, seconds, trace, 1,
                        device=torch.device("cpu"),
                        t_start=time.perf_counter(), scratch=tmp_path,
                        limits=harness.limits(workload))


def _driver(cell):
    path = getattr(cell, "driver", None) or \
        harness.resolve(BENCH, cell.name)["driver"]
    return harness.load_module(path, "driver_" + cell.name)


def _correct(outcome):
    return outcome.failed == 0 and all(v <= lim for _, v, lim in
                                       outcome.checks)


@pytest.mark.parametrize("kind", ["flagship", "swin", "serve", "loop"])
def test_driver_runs_on_cpu_and_readers_read(kind, tmp_path):
    cell = _cell(kind, tmp_path, trace=True)
    outcome = _driver(cell).run(cell)
    assert outcome.failed == 0 and outcome.attempted >= 1
    assert outcome.e2e["setup_s"] > 0
    assert {name for name, _, _ in outcome.checks} == set(cell.limits)
    assert all(v == v and v >= 0 for _, v, _ in outcome.checks)
    reading = harness.Reading(cell, outcome)
    metrics = harness.metrics_of(BENCH, cell.name, True) if kind != "loop" \
        else [{"name": n} for n in ("mfu.train", "device.idle_share.train",
                                    "loop.loader_wait_share.train",
                                    "host_aug.case_ms.train")]
    for m in metrics:
        reader = harness.load_module(harness.metric_file(m["name"]),
                                     "reader_" + m["name"])
        value = reader.read(reading)
        assert value is None or value >= 0, m["name"]
    assert outcome.window.trace.window_s > 0


@pytest.mark.parametrize("kind,fault", [
    ("flagship", "state_unchanged"), ("swin", "state_unchanged"),
    ("flagship", "half_batch"), ("swin", "half_batch"),
    ("serve", "altered_answer")])
def test_fault_in_the_timed_path_is_not_correct(kind, fault, tmp_path):
    cell = _cell(kind, tmp_path)
    with faults.planted(fault):
        assert not _correct(_driver(cell).run(cell))


@pytest.mark.parametrize("kind", ["flagship", "swin", "serve"])
def test_control_fails_and_the_program_passes_at_a_tiny_size(kind,
                                                            tmp_path):
    """The control (the reference in fp8 in the program's place) fails
    one of the cell's limits where the program passes them all, at a size
    a CPU test holds."""
    cell = _cell(kind, tmp_path, seed=2 ** 31 + 21)
    got = _driver(cell).readings(cell, control=True)
    program, _ = got["program"]
    control, _ = got["control"]
    limits = cell.limits
    assert all(v <= limits[k] for k, v in program.items() if k in limits), \
        program
    assert any(v > limits[k] for k, v in control.items() if k in limits), \
        control


def test_no_result_without_a_card(tmp_path, monkeypatch, capsys):
    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "foc_dec_amos.train_step", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_no_result_in_a_folder_without_the_port(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "foc_dec_amos.train_step", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_the_limits_at_the_cells_size(cell, card, tmp_path):
    """The reference in fp8 in the program's place, at the cell's own size
    and on three seeds, fails one of the cell's limits."""
    found = harness.resolve(BENCH, cell)
    config_file = harness.load_json(found["config_file"])
    driver = harness.load_module(found["driver"], "driver_ctl")
    limits = harness.limits(cell)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        c = harness.Cell(cell, json.loads(json.dumps(config_file["config"])),
                         config_file, found["traffic"], seed, 0.0, False, 1,
                         device=card, scratch=tmp_path, limits=limits)
        values, _ = driver.readings(c, control=True)["control"]
        assert any(v > limits[k] for k, v in values.items()), values
