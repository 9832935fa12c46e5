"""The benchmark's machinery shared by every cell: finding a cell's files by
name, the measured window (CUDA-event timing, the profiler in a traced
run), the reduction of the profiler's trace, the guard against JAX, and
the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration is ``benchmark/configs/<config>.json``, its traffic
``benchmark/traffic/<traffic>.json``, whose ``driver`` names
``benchmark/drivers/<driver>.py``; a per-layer metric is
``benchmark/metrics/<name>.py`` with a ``read(reading)`` function. None
of these needs an edit of this file.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "transoar_tpu")
SMALL_GAP_S = 50e-6  # idle gaps shorter than this are counted together


def set_cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout;
    libraries that could load JAX on their own are told not to."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path):
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One run of one cell."""
    name: str
    config: dict          # the model config as run
    config_file: dict     # the whole configuration file
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    chips: int
    device: object = None
    t_start: float = 0.0  # process start on the host clock
    scratch: Path = None  # where the run writes (under TMPDIR)
    limits: dict = None   # check name -> limit


def resolve(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry with its configuration, traffic and driver files."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config_file = root / configs[entry["config"]]["file"]
    traffic_file = root / "benchmark" / "traffic" / f"{entry['traffic']}.json"
    traffic = load_json(traffic_file)
    driver = root / "benchmark" / "drivers" / f"{traffic['driver']}.py"
    return {"entry": entry, "config_file": config_file,
            "traffic": traffic, "driver": driver}


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics,
    or in a traced run its per-layer metrics."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reported)]


def metric_file(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "metrics" / f"{name}.py"


# ---------------------------------------------------------------------------
# the measured window
# ---------------------------------------------------------------------------

class Window:
    """Brackets the measured window: a synchronize and a CUDA event at each
    end (the host clock on the CPU), the profiler around it in a traced
    run. ``elapsed()`` is host seconds since the start; ``seconds`` the
    window's length once closed; ``trace`` its ``TraceSummary``."""

    def __init__(self, device, trace: bool):
        self.device = device
        self.traced = trace
        self.seconds = None
        self.trace = None
        self._prof = None

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        import torch

        self._sync()
        if self.traced:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._span = torch.profiler.record_function("bench.window")
            self._span.__enter__()
        self.t0 = time.perf_counter()
        if self.device.type == "cuda":
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def __exit__(self, *exc):
        import torch

        if self.device.type == "cuda":
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
        self._sync()
        host = time.perf_counter() - self.t0
        self.seconds = (self._ev0.elapsed_time(ev1) / 1e3
                        if self.device.type == "cuda" else host)
        if self.traced:
            self._span.__exit__(None, None, None)
            t0 = time.perf_counter()
            self._prof.__exit__(None, None, None)
            self.trace = TraceSummary.from_profiler(self._prof)
            self._prof = None
            note(f"trace read in {time.perf_counter() - t0:.1f} s: "
                 f"{len(self.trace.device_ops)} device operations, "
                 f"{len(self.trace.host)} host operations")
        return False


def span(name: str):
    """A host span in the trace (``bench.<name>``)."""
    import torch

    return torch.profiler.record_function(f"bench.{name}")


@dataclasses.dataclass
class TraceSummary:
    """What the readers take from a traced window: every device operation
    (name, start ns, end ns), the window's bounds, the host's spans."""
    device_ops: list
    window: tuple
    host: list  # (name, start ns, end ns) of host operations
    spans: list  # (name, start ns, end ns) of the benchmark's own spans

    @classmethod
    def from_profiler(cls, prof):
        events = prof.profiler.kineto_results.events()
        window, device, host = None, [], []
        for e in events:
            name = e.name()
            if e.device_type().name == "CPU":
                if name == "bench.window":
                    window = (e.start_ns(), e.end_ns())
                elif e.duration_ns() > 0:
                    host.append((name, e.start_ns(), e.end_ns()))
            elif e.duration_ns() > 0 and not name.startswith("bench.") \
                    and not _annotation(e):
                device.append((name, e.start_ns(), e.end_ns()))
        if window is None:
            raise RuntimeError("the trace has no bench.window span")
        lo, hi = window
        device = [(n, max(a, lo), min(b, hi)) for n, a, b in device
                  if b > lo and a < hi]
        host = sorted((h for h in host if h[2] > lo and h[1] < hi),
                      key=lambda h: h[1])
        return cls(sorted(device, key=lambda d: d[1]), window,
                   [h for h in host if not h[0].startswith("bench.")],
                   [h for h in host if h[0].startswith("bench.")])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, merged."""
        merged = []
        for _, a, b in self.device_ops:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def seconds_of(self, names) -> float:
        """Device seconds of the operations whose function name is in
        ``names`` (``kernel_function``)."""
        names = set(names)
        return sum(b - a for n, a, b in self.device_ops
                   if kernel_function(n) in names) / 1e9

    def top_ops(self, k=10) -> list:
        total = {}
        for n, a, b in self.device_ops:
            key = n[:160]
            total[key] = total.get(key, 0) + (b - a)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns / 1e9] for n, ns in top]

    def idle_gaps(self, k=10) -> list:
        """Idle device time by what the host was doing: each gap of the
        window's device timeline named by the innermost benchmark span and
        the longest host operation under its middle; gaps under 50 us
        summed as one entry."""
        lo, hi = self.window
        edges = [lo]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(hi)
        starts = [h[1] for h in self.host]
        total, small = {}, 0
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            if (b - a) / 1e9 < SMALL_GAP_S:
                small += b - a
                continue
            total_key = self._host_label((a + b) // 2, starts)
            total[total_key] = total.get(total_key, 0) + (b - a)
        out = sorted(total.items(), key=lambda kv: -kv[1])
        if small:
            out.append(("gaps under 50 us", small))
            out.sort(key=lambda kv: -kv[1])
        return [[n, ns / 1e9] for n, ns in out[:k]]

    def _host_label(self, t, starts):
        span_name, span_len, op_name, op_len = None, None, None, 0
        for name, a, b in self.spans:
            if a <= t <= b and (span_len is None or b - a < span_len):
                span_name, span_len = name, b - a
        i = bisect.bisect_right(starts, t)
        for name, a, b in self.host[max(0, i - 2000):i]:
            if b >= t and b - a > op_len:
                op_name, op_len = name, b - a
        parts = [p for p in (span_name, op_name) if p]
        return " / ".join(parts) if parts else "host (no op recorded)"


def _annotation(event) -> bool:
    """Whether a device-side event only mirrors a host annotation (a
    ``record_function`` range drawn on the device's timeline)."""
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return "annotation" in str(kind())
    marked = getattr(event, "is_user_annotation", None)
    return bool(marked()) if marked is not None else False


def kernel_function(name: str) -> str:
    """The bare function name of a device operation as the trace prints it
    (``void (anonymous namespace)::conv_wide<96>(...)`` -> ``conv_wide``)."""
    head = name.replace("(anonymous namespace)::", "")
    if head.startswith("void "):
        head = head[5:]
    for sep in ("(", "<"):
        head = head.split(sep, 1)[0]
    return head.strip().rsplit("::", 1)[-1]


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Outcome:
    """What a driver hands back after its window and its check."""
    attempted: int
    failed: int
    e2e: dict                  # end-to-end metric name -> value
    checks: list               # (name, value, limit): value <= limit passes
    counters: dict             # what the per-layer readers read
    window: Window = None
    memory_peak_bytes: int = 0


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's ``read`` gets."""
    cell: Cell
    outcome: Outcome

    @property
    def trace(self) -> TraceSummary | None:
        return self.outcome.window.trace

    @property
    def window_s(self) -> float:
        return self.outcome.window.seconds

    @property
    def counters(self) -> dict:
        return self.outcome.counters


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def device_record(chips: int, trace: Window | None, peak: int) -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": int(peak),
           "power_limit": smi.stdout.strip() or None}
    if trace is not None and trace.trace is not None:
        rec["busy_s"] = trace.trace.busy_s
        rec["window_s"] = trace.trace.window_s
    return rec


def note(message: str):
    print(f"bench: {message}", file=sys.stderr, flush=True)


def checks(values: dict, limits: dict) -> list:
    """(name, reading, limit) of the readings the cell's limits compare;
    the others (numbers with no upper reading, ``PERF.md`` §2) go to
    stderr beside them."""
    for name, value in values.items():
        if name not in limits:
            note(f"reading {name}: {value} (not compared)")
    return [(k, v, limits[k]) for k, v in values.items() if k in limits]


def limits(workload: str, root: Path = ROOT) -> dict:
    """{check name: limit} of the cell (``benchmark/limits/<cell>.json``)."""
    return load_json(root / "benchmark" / "limits" / f"{workload}.json")[
        "limits"]
