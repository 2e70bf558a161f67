"""replay_ms.train: host time a batch inside ``a2m.g_step.replay`` and
``a2m.d_step.replay``: the copies into a step graph's static inputs, its
replay and the copy of its metrics, from the program's spans in the
trace."""

import program_spans as ps


def read(run):
    t = run.trace
    names = {'a2m.g_step.replay', 'a2m.d_step.replay'}
    return ps.ms_per(t, ps.span_s(t, names), 'batches')
