"""refine.forward_ms.train: the mean device ms of the port's span
``model.fpn.refine`` (the deformable refine's forward, inside
``step.forward``) over the window's steps."""

from benchmark import spans


def read(r):
    return spans.device_ms_mean("model.fpn.refine")
