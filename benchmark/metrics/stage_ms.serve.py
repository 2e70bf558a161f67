"""stage_ms.serve: host time a call inside ``a2m.serve.stage``, the
streams stacked into the pinned host buffer with its allocation, from the
program's spans in the trace."""

import program_spans as ps


def read(run):
    t = run.trace
    return ps.ms_per(t, ps.span_s(t, {'a2m.serve.stage'}), 'calls')
