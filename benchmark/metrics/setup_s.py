"""setup_s: seconds from process start to the first timed call: import,
kernels loaded from the checkout's build cache, weights, inputs, warm-up."""


def read(run):
    return run.setup_s
