"""conv_ms.train: device time of convolution kernels per batch, from the
trace."""


def read(run):
    t = run.trace
    return 1e3 * t.category_s.get('convolution', 0.0) / t.work['batches']
