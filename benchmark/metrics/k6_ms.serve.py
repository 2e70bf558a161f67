"""k6_ms.serve: device time of K6 (the speech tower's attention) a call,
from the trace, the kernel found by its name."""

import tower_cost


def read(run):
    t = run.trace
    spent = tower_cost.k6_seconds(t.op_s)
    return 1e3 * spent / t.work['calls'] if spent > 0 else None
