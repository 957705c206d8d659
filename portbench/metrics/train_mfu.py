"""The whole step's share of the card's bf16 peak: model flops a step
(``arith.flops.train_model_flops``, no remat recompute) times the
window's steps, over the window's seconds and 989 TFLOP/s, in %."""

from portbench.arith.peaks import BF16_OPS_PER_S


def read(run):
    if not run.steps:
        return None
    return 100 * run.flops_per_step * run.steps / run.window_s / BF16_OPS_PER_S
