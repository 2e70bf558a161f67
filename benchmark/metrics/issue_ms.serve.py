"""issue_ms.serve: host time a call spent issuing the model's work: the
spans ``a2m.serve.{frontend,gather,generator,blend}`` of the streaming
path and ``a2m.window.{frontend,generator}`` of the one-window path, from
the trace."""

import program_spans as ps

NAMES = {'a2m.serve.frontend', 'a2m.serve.gather', 'a2m.serve.generator',
         'a2m.serve.blend', 'a2m.window.frontend', 'a2m.window.generator'}


def read(run):
    t = run.trace
    return ps.ms_per(t, ps.span_s(t, NAMES), 'calls')
