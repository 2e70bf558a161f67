"""idle_share.train: share of the traced window in which no kernel or copy
runs on the card, from the union of the device's intervals."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
