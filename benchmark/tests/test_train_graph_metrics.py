"""The readers of the train steps' replay spans, ``graph_share.train`` and
``replay_ms.train``, on a synthetic ``harness.Trace``: steps with and
without replays, a window cutting a step, and a window with no step."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from conftest import BENCH, REPO

sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(REPO))

import harness  # noqa: E402
import yardstick  # noqa: E402


def _run(spans: list, end: float, batches: int = 2):
    window = SimpleNamespace(work={'calls': 1, 'batches': batches}, calls=1)
    trace = harness.Trace(window, [('k', 0.0, 1.0)], spans, 0.0, end,
                          yardstick.category)
    return SimpleNamespace(trace=trace)


def _read(name: str, run):
    return harness.load_module('metrics', name).read(run)


def _steps(replayed: list[bool]) -> list:
    """One step a second, alternately G and D; a replayed step holds a
    replay span of 0.25 s."""
    spans = []
    for i, replay in enumerate(replayed):
        kind = 'g' if i % 2 == 0 else 'd'
        spans.append((f'a2m.{kind}_step', float(i), i + 1.0))
        if replay:
            spans.append((f'a2m.{kind}_step.replay', i + 0.5, i + 0.75))
        else:
            spans.append((f'a2m.{kind}_step.forward', i + 0.0, i + 0.5))
    return spans


@pytest.mark.parametrize('replayed,share,replay_ms', [
    ([False] * 4, 0.0, None),
    ([True] * 4, 100.0, 500.0),
    ([False, True, True, True], 75.0, 375.0)],
    ids=['eager', 'graphs', 'mixed'])
def test_graph_share_and_replay_time(replayed, share, replay_ms):
    run = _run(_steps(replayed), 4.0)
    assert _read('graph_share.train', run) == pytest.approx(share)
    got = _read('replay_ms.train', run)
    assert got == (None if replay_ms is None else pytest.approx(replay_ms))


def test_a_window_without_steps_reads_none():
    run = _run([('a2m.train.drain', 0.0, 0.1)], 1.0)
    assert _read('graph_share.train', run) is None
    assert _read('replay_ms.train', run) is None


def test_only_the_windows_steps_count():
    """Steps outside the traced window (set-up's eager steps) are not
    counted."""
    spans = _steps([False, False]) + [
        (name, a + 2.0, b + 2.0) for name, a, b in _steps([True, True])]
    run = _run(spans, 4.0)
    run.trace.start = 2.0
    assert _read('graph_share.train', run) == pytest.approx(100.0)
