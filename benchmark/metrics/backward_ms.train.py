"""backward_ms.train: host time a batch inside ``a2m.g_step.backward`` and
``a2m.d_step.backward``, the total loss's ``backward()``, from the
program's spans in the trace."""

import program_spans as ps


def read(run):
    t = run.trace
    names = {'a2m.g_step.backward', 'a2m.d_step.backward'}
    return ps.ms_per(t, ps.span_s(t, names), 'batches')
