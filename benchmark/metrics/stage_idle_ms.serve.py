"""stage_idle_ms.serve: time a call in which the card is idle while the
host is inside ``a2m.serve.stage``: the overlap of that span with the
gaps of the union of the device's intervals, from the trace."""

import program_spans as ps


def read(run):
    t = run.trace
    return ps.ms_per(t, ps.idle_s(t, {'a2m.serve.stage'}), 'calls')
