"""predict.read_ms.serve: the median host ms of the port's span
``predict.read`` (NIfTI open, gzip inflate, header, voxels) over the
window's requests."""

from benchmark import spans


def read(r):
    return spans.host_ms_median("predict.read")
