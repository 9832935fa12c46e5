"""step.inputs_ms.train: the mean device ms of the port's span ``step.inputs``
(the window or augmentation, the targets) over the window's steps; the five
step phases' means add up to the step's event time."""

from benchmark import spans


def read(r):
    return spans.device_ms_mean("step.inputs")
