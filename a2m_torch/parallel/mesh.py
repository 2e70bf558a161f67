"""Splitting a dataset's intervals across processes.

The port's own copy of ``balanced_host_slices`` (``a2m/parallel/mesh.py:
160-186``), and the process identity it is used with: explicit arguments
first, then ``torch.distributed``'s rank and world size when a process
group is initialised, else one process.
"""

from __future__ import annotations


def process_identity() -> tuple[int, int]:
    """(rank, world size) of this process: ``torch.distributed``'s when a
    process group is initialised, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def balanced_host_slices(intervals: list, weights: list | None = None,
                         process_count: int | None = None) -> list[list]:
    """Disjoint-complete partition of ``intervals`` across processes with
    near-equal total ``weights`` (window counts) per process.

    Greedy LPT: heaviest interval first onto the currently-lightest process
    — deterministic (ties break on process index / interval order), so every
    process computes the SAME assignment from the same metadata and no
    agreement round is needed.  Per-process step counts in a multi-process
    run must match or processes desync at the first collective; the
    residual imbalance after LPT is bounded by one interval's windows and is
    removed by the DataLoader's truncate-to-global-min batch cap.
    ``process_count`` None is the world size of :func:`process_identity`.
    """
    pc = process_count if process_count is not None else process_identity()[1]
    if weights is None:
        return [intervals[i::pc] for i in range(pc)]
    assert len(weights) == len(intervals)
    order = sorted(range(len(intervals)),
                   key=lambda i: (-weights[i], i))
    loads = [0] * pc
    buckets: list[list[int]] = [[] for _ in range(pc)]
    for i in order:
        h = min(range(pc), key=lambda k: (loads[k], k))
        buckets[h].append(i)
        loads[h] += weights[i]
    return [[intervals[i] for i in sorted(b)] for b in buckets]
