"""k1_roofline.serve: the share of its roofline of K1 (both dense GCN
stacks): the least time of its launches in the traced window (the
yardstick's operations and bytes at the card's peaks) over their device
time."""


def read(run):
    t = run.trace
    spent = t.category_s.get('gcn_stack', 0.0)
    bound = t.work.get('bound_s.k1', 0.0)
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
