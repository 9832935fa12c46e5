"""def_attn_roofline: the deformable sampling's share of its roofline, %:
the bound of the forward and backward work of the op's calls in the
window (``reference.refine_work.sampling_bounds`` at the cell's shapes;
calls from the port's counter ``ms_deform_attn.calls``, which with
``.samples`` must show the cell's shapes) over the device time of the
functions the op names (``deform_kernels``, the port's
``ops.deformable_attention.KERNELS``) in the trace."""

from benchmark.reference import refine_work


def read(r):
    launches = r.counters.get("launches") or {}
    calls = launches.get("deform_calls")
    kernels = r.counters.get("deform_kernels")
    if r.trace is None or not calls or not kernels:
        return None
    bounds = refine_work.sampling_bounds(r.cell.config)
    if launches["deform_samples"] != calls * bounds["samples"]:
        return None
    seconds = r.trace.seconds_of(kernels)
    if seconds <= 0:
        return None
    return 100.0 * calls * (bounds["fwd"] + bounds["bwd"]) / seconds
