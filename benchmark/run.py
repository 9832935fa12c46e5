"""One run of one benchmark cell on the card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up, warm-up, a window of ``--seconds``, the check against the plain
reference, then one JSON line on stdout: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number with its limit,
also the last lines of stderr). Exits non-zero without printing a result
when there is no CUDA card (or fewer than the cell asks for), or when
JAX, flax or the JAX package were loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import harness  # noqa: E402


def _number(v):
    return float(v) if v is not None and math.isfinite(v) else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    harness.set_cache_dirs()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    found = harness.resolve(bench, args.workload)
    chips = int(found["entry"]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    config_file = harness.load_json(found["config_file"])
    config = json.loads(json.dumps(config_file["config"]))
    driver = harness.load_module(found["driver"],
                                 f"bench_driver_{found['traffic']['driver']}")
    with tempfile.TemporaryDirectory(prefix="transoar-bench-") as scratch:
        cell = harness.Cell(
            name=args.workload, config=config, config_file=config_file,
            traffic=found["traffic"], seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), chips=chips,
            device=torch.device("cuda", 0), t_start=T_START,
            scratch=Path(scratch), limits=harness.limits(args.workload))
        outcome = driver.run(cell)

    metrics = {}
    for m in harness.metrics_of(bench, args.workload, bool(args.trace)):
        if args.trace:
            reader = harness.load_module(harness.metric_file(m["name"]),
                                         f"bench_metric_{len(metrics)}")
            value = reader.read(harness.Reading(cell, outcome))
        else:
            value = outcome.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": _number(value), "unit": m["unit"]}

    loaded = harness.forbidden_modules()
    if loaded:
        print(f"bench: the process loaded {loaded}; no result",
              file=sys.stderr)
        return 3

    checks = {name: {"value": _number(v), "limit": limit}
              for name, v, limit in outcome.checks}
    correct = outcome.failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    result = {"correct": correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics,
              "device": harness.device_record(chips, outcome.window
                                              if args.trace else None,
                                              outcome.memory_peak_bytes)}
    if args.trace and outcome.window.trace is not None:
        result["breakdown"] = {
            "device_ops": outcome.window.trace.top_ops(),
            "idle_gaps": outcome.window.trace.idle_gaps()}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"check correct: {correct}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
