"""graph_share.train: the share of the traced window's train steps that ran
as a CUDA graph's replay: ``a2m.g_step.replay`` and ``a2m.d_step.replay``
spans over ``a2m.g_step`` and ``a2m.d_step`` spans, counted.  0 where the
steps ran eagerly (a program without graphs), None where the window holds
no step."""

STEPS = {'a2m.g_step', 'a2m.d_step'}
REPLAYS = {'a2m.g_step.replay', 'a2m.d_step.replay'}


def _count(trace, names) -> int:
    return sum(1 for name, a, b in trace.spans
               if name in names and b > trace.start and a < trace.end)


def read(run):
    t = run.trace
    steps = _count(t, STEPS)
    return 100.0 * _count(t, REPLAYS) / steps if steps else None
