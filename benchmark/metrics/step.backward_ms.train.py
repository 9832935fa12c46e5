"""step.backward_ms.train: the mean device ms of the port's span
``step.backward`` (``zero_grad``, the backward with the remat recompute)
over the window's steps; the five step phases' means add up to the step's
event time."""

from benchmark import spans


def read(r):
    return spans.device_ms_mean("step.backward")
