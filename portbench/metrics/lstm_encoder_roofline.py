"""The question encoder's share of its roofline: the least time its work
needs (``counts.lstm_bound_s``: each row's real tokens, weights from the
shapes) over the device time of ``csrc/lstm_encoder.cu``'s kernel, a step."""

KERNELS = (r"lstm_encode_kernel",)


def read(view):
    t = view.kernel_s(KERNELS)
    bound = view.work.get("lstm_bound_s", 0.0)
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
