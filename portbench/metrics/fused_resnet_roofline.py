"""The identity-stage kernel's share of its roofline: the four stages'
summed least times (``counts.stage_bound_s``) over the summed device time
of ``csrc/fused_resnet.cu``'s kernels, a request."""

KERNELS = (r"identity_block_tma", r"identity_block_f32")


def read(view):
    t = view.kernel_s(KERNELS)
    bound = view.work.get("stage_bound_s", 0.0)
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
