"""refine.sample_ms.train: the device ms a step of the functions the
deformable sampling op names (``deform_kernels``, the port's
``ops.deformable_attention.KERNELS``: forward and backward) in the
trace."""


def read(r):
    kernels = r.counters.get("deform_kernels")
    steps = r.counters.get("steps")
    if r.trace is None or not kernels or not steps:
        return None
    seconds = r.trace.seconds_of(kernels)
    return 1e3 * seconds / steps if seconds > 0 else None
