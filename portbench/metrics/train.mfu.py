"""The whole training step's share of the card's bf16 peak: the step's
operations from ``counts.train_step_flops`` over the traced stretch's wall
time."""

import counts


def read(view):
    flops = view.work.get("step_flops", 0.0)
    if flops <= 0 or view.window_s <= 0:
        return None
    return 100.0 * flops / view.window_s / counts.H100_BF16_FLOPS
