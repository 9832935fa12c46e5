"""predict.forward_ms.serve: the median ``forward_s`` that
``predict.predict_case`` returned over the window's requests, ms."""

import statistics


def read(r):
    fwd = r.counters.get("forward_s")
    return 1e3 * statistics.median(fwd) if fwd else None
