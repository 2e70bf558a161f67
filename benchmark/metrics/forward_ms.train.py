"""forward_ms.train: host time a batch inside ``a2m.g_step.forward`` and
``a2m.d_step.forward``, from each step's entry to its total loss (G, D,
the label draws and the losses), from the program's spans in the trace."""

import program_spans as ps


def read(run):
    t = run.trace
    names = {'a2m.g_step.forward', 'a2m.d_step.forward'}
    return ps.ms_per(t, ps.span_s(t, names), 'batches')
