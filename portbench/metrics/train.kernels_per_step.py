"""Device kernels a training step launches, as the trace counts them: the
host launch path's load (the encoder under autograd, the unfused hop loop,
the per-leaf optimizer)."""


def read(view):
    n = sum(view.kernel_counts.values())
    if view.steps <= 0 or n <= 0:
        return None
    return n / view.steps
