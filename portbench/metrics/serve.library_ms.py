"""Device milliseconds a serving step spends in kernels that are not the
port's own: ``embed_image``'s products, the embedding gather, the
aggregation, the casts (PyTorch's and cuBLAS's kernels)."""

# the port's kernels in a serving step: the encoder's and the hop loop's
PORT_KERNELS = (r"lstm_encode_kernel", r"rows_eval_kernel", r"\bprep_kernel", r"gemm_mma",
                r"gemm_fma", r"\bcell_kernel")


def read(view):
    if view.steps <= 0 or view.all_kernels_s() <= 0:
        return None
    return 1e3 * (view.all_kernels_s() - view.kernel_s(PORT_KERNELS)) / view.steps
