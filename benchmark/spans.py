"""The port's spans (``transoar_tpu_torch.utils.spans``) that the per-layer
readers read. The port records them only while the profiler is on, which
in a traced run is the window. A port without spans reads None."""

from __future__ import annotations

import statistics


def summary() -> dict:
    try:
        from transoar_tpu_torch.utils import spans
    except ImportError:
        return {}
    return spans.summary()


def host_ms_median(name: str):
    """The median host ms of the span's calls."""
    got = summary().get(name)
    return statistics.median(got["host_ms"]) if got and got["calls"] \
        else None


def device_ms_mean(name: str):
    """The mean device ms of the span's calls (stream order: its kernels
    and the card's waits for the host inside it)."""
    got = summary().get(name)
    return statistics.fmean(got["device_ms"]) if got and got["device_ms"] \
        else None
