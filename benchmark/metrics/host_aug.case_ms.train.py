"""host_aug.case_ms.train: the median host time of one augmented case,
ms (``HostAugmentingLoader.case_ms`` over the window's cases)."""

import statistics


def read(r):
    cases = r.counters.get("case_ms")
    return statistics.median(cases) if cases else None
