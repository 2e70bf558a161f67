"""Readings from which a cell's limits are set, on the card at the cell's
own size: the program's numbers over many seeds, and the control's (the
reference computed one precision lower, TF32 on) over a few, in one
process.  Prints one JSON line a reading.

    python3 benchmark/tests/control_readings.py --cell stream_8x60 \
        --seeds 12 --control-seeds 3 [--calls 8] [--first 3000000000]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(1, str(Path(__file__).resolve().parents[2]))

import harness  # noqa: E402


def readings(cell_name: str, seeds: list[int], control_seeds: int,
             calls: int, device=None, out=print) -> None:
    import torch
    device = torch.device(device or 'cuda')
    harness.fix_caches()
    cell = harness.load_json('workloads', cell_name)
    config = harness.load_json('configs', cell['config'])
    driver = harness.load_module('drivers', cell['driver']).Driver(
        config, cell['traffic'], seeds[0], device)
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        if i:
            driver.reseed(seed)
        for _ in range(calls):
            driver.call()
        row = dict(cell=cell_name, seed=seed, side='program',
                   **driver.verify())
        out(json.dumps(dict(row, s=time.perf_counter() - t0)))
        if i < control_seeds:
            for side, kw in driver.controls:
                out(json.dumps(dict(cell=cell_name, seed=seed, side=side,
                                    **driver.control(**kw))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--cell', required=True)
    ap.add_argument('--seeds', type=int, default=12)
    ap.add_argument('--control-seeds', type=int, default=3)
    ap.add_argument('--calls', type=int, default=8)
    ap.add_argument('--first', type=int, default=3_000_000_000)
    args = ap.parse_args()
    seeds = [args.first + 7919 * i for i in range(args.seeds)]
    readings(args.cell, seeds, args.control_seeds, args.calls,
             out=lambda line: print(line, flush=True))


if __name__ == '__main__':
    main()
