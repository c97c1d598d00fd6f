"""A transformer backbone's attention's share of its roofline: the least
time its layers' attention needs (``counts_backbones.attention_bound_s``,
summed over the traced requests) over the device time of the fused
attention kernels, which ``ops/attention.py`` reaches through
``scaled_dot_product_attention``.  The kernels are the names the card's
trace gives its flash, cuDNN and memory-efficient backends.  Left out where
the trace holds none of them (a program that materialises the scores)."""

KERNELS = (r"flash_fwd", r"flash_attn", r"fmha", r"efficient_attention",
           r"cudnn_generated_fort_native_sdpa", r"\bsdpa")


def read(view):
    t = view.kernel_s(KERNELS)
    bound = view.work.get("vit_attention_bound_s", 0.0)
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
