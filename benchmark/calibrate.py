"""Readings for the limits of a cell's check: the program's over many
seeds and the control's (the reference in fp8 in the program's place)
over a few, in one process, without a measured window; or the program's
with a fault of ``benchmark/faults.py`` planted:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... \
        [--control 3] [--fault half_batch]

One JSON line per seed on stdout: {"seed", "program": {check: reading},
"control": {...}} (the control on the first ``--control`` seeds), then
the largest program reading and the smallest control reading of each
check.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

from benchmark import faults, harness


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--fault", choices=sorted(faults.FAULTS),
                        default=None, help="read the program with this "
                        "fault planted (no control)")
    args = parser.parse_args(argv)

    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("bench: calibration runs on a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    found = harness.resolve(bench, args.workload)
    config_file = harness.load_json(found["config_file"])
    driver = harness.load_module(found["driver"], "bench_driver")
    worst, best = {}, {}
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="transoar-bench-") as tmp:
            cell = harness.Cell(
                name=args.workload,
                config=json.loads(json.dumps(config_file["config"])),
                config_file=config_file, traffic=found["traffic"],
                seed=seed, seconds=0.0, trace=False, chips=1,
                device=torch.device("cuda", 0), scratch=Path(tmp))
            with (faults.planted(args.fault) if args.fault
                  else contextlib.nullcontext()):
                got = driver.readings(cell, control=not args.fault
                                      and i < args.control)
        line = {"seed": seed, "seconds": time.perf_counter() - t0}
        for side, (values, where) in got.items():
            line[side] = values
            line[f"{side}_where"] = where
            table = worst if side == "program" else best
            pick = max if side == "program" else min
            for k, v in values.items():
                table[k] = pick(table.get(k, v), v)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"program_max": worst, "control_min": best}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
