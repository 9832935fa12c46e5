"""predict.reorient_ms.serve: the median host ms of the port's span
``predict.reorient`` (the RAS transpose and flips, the f32 cast) over the
window's requests."""

from benchmark import spans


def read(r):
    return spans.host_ms_median("predict.reorient")
