"""Run one cell of the benchmark of ``a2m_torch`` once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  The set-up builds the program and the cell's inputs from the seed and
warms up its shapes; then calls run back to back for ``--seconds``.  With
``--trace 0`` the last line of standard output is the cell's end-to-end
metrics; with ``--trace 1`` a second window of the cell's ``trace_seconds``
runs under ``torch.profiler`` and the line holds the per-layer metrics and
the trace's breakdown.  Either way the answers of a seeded sample of the
calls are then compared with the plain reference (``reference/``), and each
number compared is printed beside its limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parents[1]))

import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(message: str, code: int):
    print(f'benchmark: {message}', file=sys.stderr)
    sys.exit(code)


def main(argv=None, device=None) -> dict:
    """One run; returns the result it prints.  ``device`` None is the card,
    checked for; a CPU device (tests) skips that look."""
    args = parse(argv)
    harness.fix_caches()
    stages = {'start': harness.process_age()}
    import torch
    stages['import torch'] = harness.process_age() - stages['start']
    import yardstick
    spec = harness.benchmark_spec()
    cells = {w['name']: w for w in spec['workloads']}
    if args.workload not in cells:
        fail(f'no cell {args.workload!r} in BENCHMARK.json', 2)
    cell = harness.load_json('workloads', args.workload)
    if device is None:
        chips = cells[args.workload]['chips']
        if not torch.cuda.is_available():
            fail('CUDA is not available', 3)
        if torch.cuda.device_count() < chips:
            fail(f'{chips} cards needed, {torch.cuda.device_count()} '
                 f'found', 3)
        device = torch.device('cuda')
    device = torch.device(device)
    config = harness.load_json('configs', cell['config'])
    driver_cls = harness.load_module('drivers', cell['driver']).Driver
    driver = driver_cls(config, cell['traffic'], args.seed, device)
    if device.type == 'cuda':
        torch.cuda.synchronize()
    setup_s = harness.process_age()
    stages.update(getattr(driver, 'stages', {}))
    print('set-up ' + ', '.join(f'{k} {v:.2f} s' for k, v in stages.items()),
          file=sys.stderr)

    run = harness.Run(config, setup_s)
    run.window = harness.measure(driver, args.seconds)
    print('window ' + run.window.quarters() + '; work '
          + json.dumps(run.window.work), file=sys.stderr)
    if args.trace:
        run.trace = harness.traced(driver, cell['trace_seconds'],
                                   yardstick.category)
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == 'cuda' else 0)
    kind = 'per_layer' if args.trace else 'end_to_end'
    metrics = {}
    for m in harness.cell_metrics(spec, args.workload, kind):
        value = harness.load_module('metrics', m['name']).read(run)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    driver.release()
    readings = driver.verify()
    limits = cell['limits']
    checks = {name: {'value': readings[name], 'limit': limit}
              for name, limit in limits.items()}
    correct = all(c['value'] <= c['limit'] for c in checks.values())
    device_info = {'platform': 'gpu' if device.type == 'cuda' else 'cpu',
                   'kind': (torch.cuda.get_device_name(device)
                            if device.type == 'cuda' else 'cpu'),
                   'count': 1, 'memory_peak_bytes': memory}
    result = {'correct': correct, 'attempted': run.window.calls,
              'failed': 0, 'metrics': metrics, 'device': device_info}
    if args.trace:
        device_info.update(busy_s=run.trace.busy_s,
                           window_s=run.trace.window_s)
        result['breakdown'] = run.trace.breakdown()
    result['checks'] = checks
    for name, leaf in getattr(driver, 'worst', {}).items():
        print(f'worst leaf {name} {leaf}', file=sys.stderr)
    for name, value in readings.items():
        if name not in checks:
            print(f'reading {name} {value!r} (not compared)', file=sys.stderr)
    # the last look before the result: the reference and the comparison
    # have run, so whatever they loaded is in ``sys.modules`` too
    found = harness.forbidden_modules()
    if found:
        fail('modules of JAX or of the JAX package are loaded: '
             + ', '.join(found), 4)
    for name, c in checks.items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
