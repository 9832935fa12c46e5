"""mfu.serve: the model's forward FLOPs of the requests served in the
window (one volume each) over the window's seconds times the card's
dense bf16 peak, %."""

from benchmark.reference import work


def read(r):
    served = r.counters.get("served")
    if not served:
        return None
    flops = work.model_flops(r.cell.config, 1, False)
    return 100.0 * served * flops / (r.window_s * work.PEAK_BF16_FLOPS)
