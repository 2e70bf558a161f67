"""The program's own spans in a traced window, reduced: their summed time,
the part of it in which the card was idle, and either per call or batch.

The program opens its spans through ``a2m_torch.utils.profiling``'s
``trace_annotation`` (``torch.profiler.record_function``), all named
``a2m.*`` and flat below their root, so that a span's time is its self
time; ``harness.traced`` keeps them.  The benchmark keeps this reduction
itself, as it keeps ``yardstick.py``, and imports none of the program's.
A name the window holds no span of reads as None: a program without the
span reports no metric.
"""

from __future__ import annotations

import bisect


def _found(trace, names) -> list[tuple[float, float]]:
    """The (start, end) of the spans named in ``names``, cut to the
    window."""
    return [(max(a, trace.start), min(b, trace.end))
            for name, a, b in trace.spans
            if name in names and b > trace.start and a < trace.end]


def span_s(trace, names) -> float | None:
    """Seconds inside the spans named in ``names``, or None."""
    found = _found(trace, names)
    return sum(b - a for a, b in found) if found else None


def idle_s(trace, names) -> float | None:
    """Seconds of the card's idle gaps (``Trace.idle_gaps``) that fall
    inside the spans named in ``names``, or None."""
    found = _found(trace, names)
    if not found:
        return None
    gaps = trace.idle_gaps()
    ends = [b for _, b in gaps]
    total = 0.0
    for a, b in found:
        for g0, g1 in gaps[bisect.bisect_right(ends, a):]:
            if g0 >= b:
                break
            total += min(b, g1) - max(a, g0)
    return total


def ms_per(trace, seconds: float | None, unit: str) -> float | None:
    """``seconds`` in ms per ``unit`` of the window's work (``calls`` or
    ``batches``), or None."""
    return None if seconds is None else 1e3 * seconds / trace.work[unit]
