"""predict.resize_ms.serve: the median host ms of the port's span
``predict.resize`` (the zoom to the model's grid, crop or pad) over the
window's requests."""

from benchmark import spans


def read(r):
    return spans.host_ms_median("predict.resize")
