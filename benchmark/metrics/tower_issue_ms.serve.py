"""tower_issue_ms.serve: host time a call inside ``a2m.serve.tower``, the
speech tower's extractor, projection, encoder, join and resample issued,
from the program's spans in the trace."""

import program_spans as ps


def read(run):
    t = run.trace
    return ps.ms_per(t, ps.span_s(t, {'a2m.serve.tower'}), 'calls')
