"""mfu.train: the model FLOPs of the train steps completed in the window
(``reference.work.model_flops`` at the cell's batch, forward and
backward) over the window's seconds times the card's dense bf16 peak, %."""

from benchmark.reference import work


def read(r):
    steps = r.counters.get("steps")
    if not steps:
        return None
    cfg = r.cell.config
    flops = work.model_flops(cfg, cfg["trainer"]["batch_size"], True)
    return 100.0 * steps * flops / (r.window_s * work.PEAK_BF16_FLOPS)
