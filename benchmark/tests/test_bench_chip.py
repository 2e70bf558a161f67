"""The control of each cell, on the card at the cell's own size: the
program's answers fall within every limit, and the reference computed one
precision lower (TF32 on) fails at least one.  Skips without a card.

    python -m pytest benchmark/tests/test_bench_chip.py -q -m chip
"""

from __future__ import annotations

import json
import sys

import pytest

from conftest import BENCH, REPO

sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(REPO))

SPEC = json.loads((REPO / 'BENCHMARK.json').read_text())


@pytest.mark.chip
@pytest.mark.parametrize('cell', [w['name'] for w in SPEC['workloads']])
def test_the_control_fails_and_the_program_passes(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    import control_readings
    import harness
    limits = harness.load_json('workloads', cell)['limits']
    rows: list[dict] = []
    control_readings.readings(cell, [3_141_592_653], 1, 4,
                              out=lambda line: rows.append(json.loads(line)))
    program = next(r for r in rows if r['side'] == 'program')
    control = next(r for r in rows if r['side'] == 'control_tf32')
    assert all(program[k] <= v for k, v in limits.items()), program
    assert any(control[k] > v for k, v in limits.items()), control
