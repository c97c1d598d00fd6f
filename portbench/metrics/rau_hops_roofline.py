"""The serving hop loop's share of its roofline: the least time its work
needs (``counts.hops_bound_s``, from the shapes) over the device time of its
kernels, a step.  The kernels are those ``csrc/rau_hops.cu`` launches, by
the names the card's trace shows."""

KERNELS = (r"rows_eval_kernel", r"\bprep_kernel", r"gemm_mma", r"gemm_fma", r"\bcell_kernel")


def read(view):
    t = view.kernel_s(KERNELS)
    bound = view.work.get("hops_bound_s", 0.0)
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
