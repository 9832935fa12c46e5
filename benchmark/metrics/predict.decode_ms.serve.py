"""predict.decode_ms.serve: the median host ms of the port's span
``predict.decode`` (the per-organ decode and the detection records) over the
window's requests."""

from benchmark import spans


def read(r):
    return spans.host_ms_median("predict.decode")
