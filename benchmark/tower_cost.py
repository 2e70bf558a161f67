"""Operations and bytes of the speech tower's attention kernel (K6), kept
with the benchmark so that a change to the measured program cannot change
how it is measured: frozen copies of ``rel_attention_flops`` and
``rel_attention_bytes`` of ``a2m_torch/nn/rel_attention.py``, and the name
by which the device trace shows the kernel (``CATEGORIES`` of
``yardstick.py`` is frozen and does not know it).  Also K5's cost over the
chunks of windows that a serving call hands it, which the drivers of the
tower and of unequal streams share."""

from __future__ import annotations

import common
import yardstick

#: a substring of K6's kernel name in the device trace
K6_NAME = 'rel_attn_k6'


def k6_flops(b: int, h: int, t: int, d: int) -> int:
    """QK^T and PV over every (query, key) pair: 4 B H T^2 D."""
    return 4 * b * h * t * t * d


def k6_bytes(b: int, h: int, t: int, d: int) -> int:
    """q, k, v in bf16 read once, the f32 output written once, the f32
    gates (B, H, T) and the f32 (H, 2T - 1) table read once."""
    return 3 * 2 * b * h * t * d + 4 * b * h * t * d + 4 * b * h * t \
        + 4 * h * (2 * t - 1)


def k6_seconds(op_s: dict) -> float:
    """Device seconds of K6's launches among a trace's ``op_s``."""
    return sum(s for name, s in op_s.items() if K6_NAME in name)


def k5_cost(gen_cfg: dict, rows: list[int]) -> tuple[float, float]:
    """(operations, least seconds) of K5's launches over ``rows``: each
    entry the rows (windows x frames) of one call of the generator, which
    launches K5 once for the body stack and once for the hands."""
    flops = bound = 0.0
    for n in rows:
        for adj, f, h in common.stack_shapes(gen_cfg):
            fl = yardstick.stack_flops(n, adj, f, h)
            flops += fl
            bound += yardstick.bound_s(
                fl, yardstick.stack_edge_bytes(n, adj, f, h), 'bf16')
    return flops, bound
