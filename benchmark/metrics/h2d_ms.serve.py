"""h2d_ms.serve: device time of host-to-device copies per call, from the
trace."""


def read(run):
    t = run.trace
    return 1e3 * sum(s for n, s in t.op_s.items() if "HtoD" in n) / \
        t.work["calls"]
