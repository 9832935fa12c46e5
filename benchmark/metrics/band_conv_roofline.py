"""band_conv_roofline: the stage-0 band conv's share of its roofline, %:
the bound of the work its launches in the window did (forward, input
gradient and weight gradient of the 3x3x3 convs they compute; launches
from the port's counters ``packed_conv.launches``, ``packed_conv_dx``,
``packed_conv_dw``) over the device time of the kernels below in the
trace. The forward counter alternates the chain's two convs and the
weight-gradient counter likewise."""

from benchmark.reference import work

KERNELS = ("conv_mma", "conv_wide", "conv_fold", "conv_fma", "dw_mma",
           "dw_fma", "dw_wide", "dw_fold", "dw_reduce")


def read(r):
    bounds = work.band_conv_bounds(r.cell.config)
    launches = r.counters.get("launches")
    if r.trace is None or bounds is None or not launches:
        return None
    seconds = r.trace.seconds_of(KERNELS)
    if seconds <= 0:
        return None
    need = (launches["band_fwd"] / 2 * bounds["fwd"]
            + launches["band_dx"] * bounds["dx"]
            + launches["band_dw"] / 2 * bounds["dw"])
    return 100.0 * need / seconds
