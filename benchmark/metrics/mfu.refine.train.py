"""mfu.refine.train: the model FLOPs of the train steps completed in the
window (``reference.refine_work.model_flops`` at the cell's batch, forward
and backward: the plain reference with the deformable refine) over the
window's seconds times the card's dense bf16 peak, %: the refine cell's
whole-step share."""

from benchmark.reference import refine_work, work


def read(r):
    steps = r.counters.get("steps")
    if not steps:
        return None
    cfg = r.cell.config
    flops = refine_work.model_flops(cfg, cfg["trainer"]["batch_size"], True)
    return 100.0 * steps * flops / (r.window_s * work.PEAK_BF16_FLOPS)
