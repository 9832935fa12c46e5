"""predict.host_share.serve: the share of the served requests' time spent
outside the forward, %: 1 - sum(forward_s) / sum(service time), where
``forward_s`` is what ``predict.predict_case`` returns (the host clock
around the forward, ending with the copy to the host) and the service
time is the call of ``predict_case`` (NIfTI read to detections)."""


def read(r):
    fwd, service = r.counters.get("forward_s"), r.counters.get("service_s")
    if not fwd or not service:
        return None
    return 100.0 * (1.0 - sum(fwd) / sum(service))
