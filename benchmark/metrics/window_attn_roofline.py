"""window_attn_roofline: the fused window attention's share of its
roofline, %: the bound of every Swin block's forward and backward at the
cell's shapes (``reference.work.window_bounds``), times the launches in
the window over the blocks of one step (the port's counters
``fused_window_attention.launches`` and ``..._bwd.launches``), over the
device time of the kernels below in the trace."""

from benchmark.reference import work

KERNELS = ("fwd_mma", "bwd_mma", "fwd_wg", "bwd_wg", "fwd_fma", "bwd_fma",
           "dbias_reduce")


def read(r):
    bounds = work.window_bounds(r.cell.config)
    launches = r.counters.get("launches")
    if r.trace is None or bounds is None or not launches:
        return None
    seconds = r.trace.seconds_of(KERNELS)
    if seconds <= 0:
        return None
    need = (launches["window_fwd"] * bounds["fwd"]
            + launches["window_bwd"] * bounds["bwd"]) / bounds["blocks"]
    return 100.0 * need / seconds
