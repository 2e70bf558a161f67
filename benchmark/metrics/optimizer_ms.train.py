"""optimizer_ms.train: host time a batch inside ``a2m.g_step.optimizer``
and ``a2m.d_step.optimizer``: the gradients' all-reduce (none in one
process), the global-norm clip and Adam, from the program's spans in the
trace."""

import program_spans as ps


def read(run):
    t = run.trace
    names = {'a2m.g_step.optimizer', 'a2m.d_step.optimizer'}
    return ps.ms_per(t, ps.span_s(t, names), 'batches')
