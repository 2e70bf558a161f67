"""The readers of the program's spans (``program_spans.py`` and the six
metrics that use it) on a synthetic ``harness.Trace``, and a traced tiny
streaming run that reports one of them."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from conftest import BENCH, REPO, run_cell

sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(REPO))

import harness  # noqa: E402
import program_spans as ps  # noqa: E402
import yardstick  # noqa: E402


def _run(work: dict, events: list, spans: list, end: float):
    window = SimpleNamespace(work=work, calls=work.get('calls', 1))
    trace = harness.Trace(window, events, spans, 0.0, end,
                          yardstick.category)
    return SimpleNamespace(trace=trace)


def _read(name: str, run):
    return harness.load_module('metrics', name).read(run)


def test_serving_spans_and_their_overlap_with_the_idle_card():
    """Two calls: each stages for 2 s with a kernel over the second half
    of the stage (1 s idle), then issues and waits."""
    events = [('kern_a', 1.0, 2.5), ('Memcpy HtoD', 2.5, 3.0),
              ('kern_b', 6.0, 8.0)]
    spans = [('a2m.serve', 0.0, 5.0), ('a2m.serve.stage', 0.0, 2.0),
             ('a2m.serve.upload', 2.0, 2.1),
             ('a2m.serve.frontend', 2.1, 2.3),
             ('a2m.serve.generator', 2.3, 3.0),
             ('a2m.serve.download', 3.0, 5.0),
             ('a2m.serve', 5.0, 10.0), ('a2m.serve.stage', 5.0, 7.0),
             ('a2m.serve.blend', 7.0, 7.5),
             ('a2m.window.generator', 9.5, 12.0)]     # cut at the window
    run = _run({'calls': 2}, events, spans, 10.0)
    t = run.trace
    assert ps.span_s(t, {'a2m.serve.stage'}) == pytest.approx(4.0)
    # idle 0-1 of the first stage, 5-6 of the second
    assert ps.idle_s(t, {'a2m.serve.stage'}) == pytest.approx(2.0)
    assert _read('stage_ms.serve', run) == pytest.approx(2000.0)
    assert _read('stage_idle_ms.serve', run) == pytest.approx(1000.0)
    # frontend 0.2 + generator 0.7 + blend 0.5 + window 0.5, over 2 calls
    assert _read('issue_ms.serve', run) == pytest.approx(950.0)


def test_training_spans_per_batch():
    spans = [('a2m.g_step', 0.0, 3.0), ('a2m.g_step.forward', 0.0, 1.0),
             ('a2m.g_step.backward', 1.0, 2.5),
             ('a2m.g_step.optimizer', 2.5, 3.0),
             ('a2m.d_step', 3.0, 4.0), ('a2m.d_step.forward', 3.0, 3.2),
             ('a2m.d_step.backward', 3.2, 3.9),
             ('a2m.d_step.optimizer', 3.9, 4.0),
             ('a2m.train.drain', 4.0, 4.5)]
    run = _run({'calls': 1, 'batches': 2}, [('k', 0.5, 1.5)], spans, 5.0)
    assert _read('forward_ms.train', run) == pytest.approx(600.0)
    assert _read('backward_ms.train', run) == pytest.approx(1100.0)
    assert _read('optimizer_ms.train', run) == pytest.approx(300.0)


@pytest.mark.parametrize('name', [
    'stage_ms.serve', 'stage_idle_ms.serve', 'issue_ms.serve',
    'forward_ms.train', 'backward_ms.train', 'optimizer_ms.train'])
def test_a_program_without_the_spans_reports_nothing(name):
    """The parent of the change that added the spans has only the step
    regions: each reader returns None, and raises nothing."""
    spans = [('a2m.g_step', 0.0, 1.0), ('a2m.d_step', 1.0, 2.0)]
    run = _run({'calls': 1, 'batches': 1}, [('k', 0.0, 1.0)], spans, 2.0)
    assert _read(name, run) is None


def test_a_traced_stream_run_reports_its_stage(tiny_tree):
    result, err = run_cell(tiny_tree, 'tiny_stream', trace=1)
    assert result['correct'], err[-2000:]
    metrics = result['metrics']
    assert metrics['stage_ms.serve']['value'] > 0
    assert 0 <= metrics['stage_idle_ms.serve']['value'] <= \
        metrics['stage_ms.serve']['value']
    assert metrics['issue_ms.serve']['unit'] == 'ms'
