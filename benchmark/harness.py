"""The benchmark's machinery: finding a cell's files by name, the measured
window, the traced window and its reduction, the result line.

Everything that belongs to one configuration, one traffic mix, one driver
(the kind of entry a cell calls) or one metric sits in a file of its own,
found here by the name ``BENCHMARK.json`` and the cell's workload file give:

* ``configs/<config>.json``: the configuration's sizes and precision;
* ``workloads/<cell>.json``: ``config``, ``driver``, ``traffic`` (the
  parameters the traffic generator reads), ``chips`` and ``why``;
* ``drivers/<driver>.py``: ``Driver(config, traffic, seed, device)``, whose
  construction is the set-up, ``call()`` one timed call returning the work
  it did, ``verify()`` the comparison with the plain reference;
* ``metrics/<metric>.py``: ``read(run)``, the metric's value or None.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'a2m')


def load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f'{name}.json'
    if not path.is_file():
        raise FileNotFoundError(f'no {kind[:-1]} named {name!r} ({path})')
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f'{name}.py'
    if not path.is_file():
        raise FileNotFoundError(f'no {kind[:-1]} named {name!r} ({path})')
    modname = f'bench_{kind}_{name}'.replace('.', '_').replace('-', '_')
    spec = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[modname] = module
    spec.loader.exec_module(module)
    return module


def benchmark_spec() -> dict:
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def cell_metrics(spec: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports:
    those without a ``workloads`` list, and those whose list names it."""
    return [m for m in spec[kind]
            if 'workloads' not in m or cell in m['workloads']]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared as whole names (``a2m_torch`` is not ``a2m``)."""
    return sorted({name for name in sys.modules
                   if name.split('.', 1)[0] in FORBIDDEN})


def process_age() -> float:
    """Seconds since this process started (``/proc``; clock ticks)."""
    with open('/proc/self/stat') as f:
        start_ticks = int(f.read().rsplit(')', 1)[1].split()[19])
    with open('/proc/uptime') as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf('SC_CLK_TCK')


def fix_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own ``nvcc`` builds already live in ``build/a2m_torch``)."""
    cache = ROOT / 'build' / 'benchmark_cache'
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton'),
                     ('CUDA_CACHE_PATH', 'cuda')):
        os.environ[var] = str(cache / sub)


class Stopwatch:
    """Seconds of each named stage of a set-up, in order."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps: dict[str, float] = {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now


def add_work(total: dict, work: dict) -> None:
    for k, v in work.items():
        total[k] = total.get(k, 0) + v


class Window:
    """Calls made back to back for at least ``seconds``: each call's start
    and end on the host clock, and the work it reports."""

    def __init__(self):
        self.durations: list[float] = []
        self.work: dict = {}
        self.seconds = 0.0

    @property
    def calls(self) -> int:
        return len(self.durations)

    def quarters(self) -> str:
        """Mean and largest call in ms of each quarter of the calls: whether
        a window is steady."""
        d, n = self.durations, len(self.durations)
        parts = [d[i * n // 4:(i + 1) * n // 4] for i in range(4)]
        return ' | '.join(f'{1e3 * sum(p) / len(p):.3f} / '
                          f'{1e3 * max(p):.3f} ms' for p in parts if p)


def measure(driver, seconds: float, span=None) -> Window:
    """Call ``driver.call()`` until ``seconds`` have passed; the window is
    from the first call's start to the last call's end."""
    win = Window()
    t0 = t = time.perf_counter()
    while t - t0 < seconds:
        if span is None:
            work = driver.call()
        else:
            with span(driver.span):
                work = driver.call()
        t1 = time.perf_counter()
        win.durations.append(t1 - t)
        add_work(win.work, work)
        t = t1
    win.seconds = t - t0
    return win


class Trace:
    """A traced window reduced: its length, device intervals by name, the
    union of device activity, the host spans, and the work of its calls."""

    def __init__(self, window: Window, events: list, spans: list,
                 start: float, end: float, categorize):
        self.window = window
        self.window_s = end - start
        self.work = window.work
        self.calls = window.calls
        self.device = [(n, max(a, start), min(b, end)) for n, a, b in events
                       if b > start and a < end]
        self.spans = spans
        self.op_s: dict = defaultdict(float)
        self.category_s: dict = defaultdict(float)
        self.kernels = 0
        for name, a, b in self.device:
            self.op_s[name] += b - a
            self.category_s[categorize(name)] += b - a
            if not name.startswith(('Memcpy', 'Memset')):
                self.kernels += 1
        self.busy = _union(self.device)
        self.busy_s = sum(b - a for a, b in self.busy)
        self.start, self.end = start, end

    def idle_gaps(self) -> list[tuple[float, float]]:
        gaps, t = [], self.start
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:top]
        by_span: dict = defaultdict(float)
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        for a, b in self.idle_gaps():
            mid = (a + b) / 2
            inner, width = 'between calls', float('inf')
            for name, s0, s1 in spans[:bisect.bisect_right(starts, mid)]:
                if s0 <= mid <= s1 and s1 - s0 < width:
                    inner, width = name, s1 - s0
            by_span[inner] += b - a
        gaps = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
        return dict(device_ops=[[n[:160], s] for n, s in ops],
                    idle_gaps=[[n, s] for n, s in gaps])


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for _, a, b in sorted(intervals, key=lambda e: e[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


#: host spans of the benchmark and of the program kept for the breakdown
SPAN_PREFIXES = ('bench.', 'a2m.')


def traced(driver, seconds: float, categorize) -> Trace:
    """Calls for ``seconds`` under ``torch.profiler`` (host and card), the
    whole traced window inside the span ``bench.window``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if card else [])
    if card:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function('bench.window'):
            win = measure(driver, seconds, record_function)
            if card:
                torch.cuda.synchronize()
    events, spans, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, b = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # a span also shows on the card's timeline, over the work
            # launched inside it: it is no device operation
            annotation = getattr(e, 'is_user_annotation', lambda: False)()
            if not (annotation or name.startswith(
                    SPAN_PREFIXES) or name == 'bench.window'):
                events.append((name, a, b))
        elif name == 'bench.window':
            window = (a, b)
        elif name.startswith(SPAN_PREFIXES):
            spans.append((name, a, b))
    if window is None:
        raise RuntimeError('the profiler recorded no bench.window span')
    return Trace(win, events, spans, window[0], window[1], categorize)


def quantile(values, q: float) -> float:
    """The q-quantile of ``values`` (Python's ``statistics.quantiles``
    exclusive method, 100 cut points)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100)[round(q * 100) - 1]


class Run:
    """What a metric's reader reads: the configuration, the set-up seconds,
    the measured window and, with ``--trace 1``, the traced one."""

    def __init__(self, config: dict, setup_s: float):
        self.config, self.setup_s = config, setup_s
        self.window: Window | None = None
        self.trace: Trace | None = None

    @property
    def peak_flops(self) -> float:
        """The published peak of the configuration's compute precision."""
        import yardstick
        return yardstick.PEAK_FLOPS[self.config['precision']['compute']]
