"""Named spans at the phase boundaries of the port's timed paths.

``with span("step.forward"): ...`` marks one phase. The rule:

- **Off** while no torch profiler is recording (the default): ``span``
  returns one shared ``contextlib.nullcontext()``. It reads no clock,
  records no event and allocates nothing; a flag check is its whole cost.
- **On** under ``torch.profiler.profile`` (or any profiler that sets the
  autograd profiler's flag): the span is a ``record_function`` range, a
  host range on the profiler's own clock, so the device trace shows what
  the host was doing; the profiler mirrors it on the device's timeline
  (the span's first kernel to its last). It also takes host ms
  (``time.perf_counter`` at entry and exit). The train step's phases
  (``TIMED``), once CUDA is initialised, also record a pair of timing
  events on the current stream, whose device ms the benchmark reads: the
  stream-order interval from the work queued before the span to the
  span's last work, its kernels plus any idle the card spent waiting for
  the host inside it, so the phases add up to the step. The deformable
  refine of the FPN levels, ``model.fpn.refine``, takes a pair too: it
  nests inside ``step.forward`` and is not one of the five phases that add
  up to the step.

Spans may nest; an exception still closes the span. ``summary()`` gives
``{name: {"calls", "host_ms", "device_ms"}}`` (one synchronize resolves
the pending events; the registry is kept, so several readers may read it
in turn); ``clear()`` empties it. The registry keeps every call, events
included, until ``clear()``: a caller that profiles for long (a repeating
``torch.profiler.schedule``) reads and clears it after each active
stretch. It is written from the thread that runs the phases.

The spans: ``predict.read`` / ``.reorient`` / ``.resize`` / ``.forward`` /
``.decode`` (``predict.py``), ``step.inputs`` / ``.forward`` /
``.criterion`` / ``.backward`` / ``.update`` (``training/trainer.py``),
``model.encoder.stage<i>``, ``model.fpn``, ``model.fpn.refine``,
``model.neck``, ``model.heads``, ``model.seg_head``, ``model.cls_tower``,
``model.reg_tower`` (``models/``), ``ops.ms_deform_attn`` (``ops/``).
"""

from __future__ import annotations

import contextlib
import time

import torch

_OFF = contextlib.nullcontext()
# the spans whose device ms a reader uses (the benchmark's step.* metrics
# and refine.forward_ms.train)
TIMED = frozenset(("step.inputs", "step.forward", "step.criterion",
                   "step.backward", "step.update", "model.fpn.refine"))
# name -> [[host ms, device ms | (start event, end event) | None], ...]
_registry: dict[str, list] = {}


def span(name: str):
    """The phase ``name``: a shared null context unless a profiler records."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _Span(name)


class _Span:
    __slots__ = ("name", "_range", "_start", "_t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._start = None
        if self.name in TIMED and torch.cuda.is_initialized():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_ms = 1e3 * (time.perf_counter() - self._t0)
        device = None
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            device = (self._start, end)
        self._range.__exit__(*exc)
        _record(self.name, host_ms, device)
        return False


def _record(name: str, host_ms: float, device=None):
    _registry.setdefault(name, []).append([host_ms, device])


def summary() -> dict:
    """{name: {"calls": n, "host_ms": [...], "device_ms": [...]}}."""
    pending = [row for rows in _registry.values() for row in rows
               if isinstance(row[1], tuple)]
    if pending:
        torch.cuda.synchronize()
        for row in pending:
            row[1] = row[1][0].elapsed_time(row[1][1])
    return {name: {"calls": len(rows),
                   "host_ms": [r[0] for r in rows],
                   "device_ms": [r[1] for r in rows if r[1] is not None]}
            for name, rows in _registry.items()}


def clear():
    _registry.clear()
