"""Device milliseconds a serving step spends in the image embedding's
kernels (``csrc/embed_image.cu``, whose kernels all carry ``embed_image`` in
their names), a step; None where the trace has none (a program that runs the
embedding as library products)."""

KERNELS = (r"embed_image",)


def read(view):
    t = view.kernel_s(KERNELS)
    if view.steps <= 0 or t <= 0:
        return None
    return 1e3 * t / view.steps
