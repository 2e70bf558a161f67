"""call_p95_ms: the 95th percentile of every call of the measured
window, each timed from its issue until its poses are on the host."""

import harness


def read(run):
    return 1e3 * harness.quantile(run.window.durations, 0.95)
