"""Device milliseconds a from-pixels request spends in kernels that are not
the port's own: the stem and the downsample blocks (cuDNN), the
normalization and the other elementwise passes, the head's PyTorch ops."""

# the port's kernels in a request: the identity stages', the encoder's and
# the hop loop's
PORT_KERNELS = (r"identity_block_tma", r"identity_block_f32", r"lstm_encode_kernel",
                r"rows_eval_kernel", r"\bprep_kernel", r"gemm_mma", r"gemm_fma", r"\bcell_kernel")


def read(view):
    if view.steps <= 0 or view.all_kernels_s() <= 0:
        return None
    return 1e3 * (view.all_kernels_s() - view.kernel_s(PORT_KERNELS)) / view.steps
