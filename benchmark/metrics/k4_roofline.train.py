"""k4_roofline.train: the share of its roofline of K4 (the GCN stacks'
backward): the least time of its launches in the traced window (the
yardstick's operations and bytes at the card's peaks) over their device
time."""


def read(run):
    t = run.trace
    spent = t.category_s.get('gcn_stack_bwd', 0.0)
    bound = t.work.get('bound_s.k4', 0.0)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
