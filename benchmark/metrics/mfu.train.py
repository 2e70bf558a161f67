"""mfu.train: the operations of the measured window's batches over the
configuration's published peak times the window's wall: the whole
batch's share of the card."""


def read(run):
    w = run.window
    return 100.0 * w.work['flops'] / (run.peak_flops * w.seconds)
