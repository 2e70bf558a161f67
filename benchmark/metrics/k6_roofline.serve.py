"""k6_roofline.serve: the share of its roofline of K6 (the speech tower's
attention with the gated relative bias): the least time of its launches in
the traced window (``tower_cost``'s operations at the bf16 peak, or its
bytes at the memory's) over their device time, the kernel found by its
name."""

import tower_cost


def read(run):
    t = run.trace
    spent = tower_cost.k6_seconds(t.op_s)
    bound = t.work.get('bound_s.k6', 0.0)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
