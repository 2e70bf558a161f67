"""Data parallelism across processes: splitting the data, and the global
batch the train steps compute over.

The port's own copy of ``balanced_host_slices`` and ``host_interval_slice``
(``a2m/parallel/mesh.py:145-186``), the process identity they are used
with (explicit arguments first, then ``torch.distributed``'s rank and world
size when a process group is initialised, else one process), and the
global batch that stands in for ``make_sharded_train_steps``
(``:188-227``): the port's own train steps run inside it.

In a2m a multi-process run is one global program over a mesh: the
BatchNorm moments, the losses and so the gradients are taken over the
global batch, and GSPMD inserts the gradient psum.  The port runs one
process per card, each on its own slice of the batch, and reproduces that
with explicit collectives inside :func:`global_batch`:

* ``MaskedBatchNorm`` (train mode) all-reduces its masked sums, so its
  moments and running statistics are the concatenated batch's, and the
  reductions are differentiable (their backward all-reduces too);
* ``losses.masked_mean`` divides each rank's sum by the global mask sum,
  so the ranks' terms add up to a2m's global loss;
* the steps (:func:`a2m_torch.train.train_step.make_train_steps`, which
  enter the context whenever a process group is up) all-reduce (sum) the
  gradients before clipping and Adam, in one flat buffer a model, and
  return the global sums of their metrics;
* label noise is drawn at the global batch's shape and each rank takes its
  own rows.

Tensor parallelism (a2m's ``TP_RULES``, ``param_spec``,
``param_shardings``) and one process over several devices are not ported:
``config.validate`` refuses ``mesh.model > 1`` and, in one process,
``mesh.data > 1`` (ROADMAP A13b).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_group_var: contextvars.ContextVar = contextvars.ContextVar(
    'a2m_torch_global_batch', default=None)


def process_identity() -> tuple[int, int]:
    """(rank, world size) of this process: ``torch.distributed``'s when a
    process group is initialised, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_interval_slice(intervals: list, process_index: int | None = None,
                        process_count: int | None = None) -> list:
    """Stride ``intervals`` across processes: process ``i`` of ``n`` takes
    ``intervals[i::n]``.  Striding balances interval counts, not window
    counts: the data loader uses :func:`balanced_host_slices`."""
    rank, world = process_identity()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    return intervals[pi::pc]


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


# ---- the global batch --------------------------------------------------------

class _GlobalBatch:
    """The process group of one step, and the global mask sums it has
    taken (one all-reduce per mask a step)."""

    def __init__(self, group):
        import torch.distributed as dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self._sums: dict = {}

    def mask_sum(self, mask: torch.Tensor) -> torch.Tensor:
        """Σ mask over the global batch (no gradient)."""
        import torch.distributed as dist
        hit = self._sums.get(id(mask))
        if hit is None or hit[0] is not mask:
            total = mask.detach().sum()
            dist.all_reduce(total, group=self.group)
            hit = self._sums[id(mask)] = (mask, total)
        return hit[1]

    def rows(self, n_local: int) -> tuple[int, int]:
        """(first row of this rank, global rows): every rank holds
        ``n_local`` rows (the loader pads each batch to its size)."""
        return self.rank * n_local, self.world * n_local


@contextlib.contextmanager
def global_batch():
    """Within the context, the port's batch reductions (train-mode
    ``MaskedBatchNorm``, ``losses.masked_mean``, the label noise, the
    optimiser's gradients, the steps' metrics) run over the global batch of
    all ranks, as a2m's one global program does.  Without a process group
    it changes nothing.  The train steps run inside it (used as their
    decorator)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        yield
        return
    token = _group_var.set(_GlobalBatch(dist.group.WORLD))
    try:
        yield
    finally:
        _group_var.reset(token)


def active() -> _GlobalBatch | None:
    """The enclosing :func:`global_batch`, or None."""
    return _group_var.get()


def mask_sum(mask: torch.Tensor) -> torch.Tensor:
    """Σ ``mask`` over the batch: the global batch's inside
    :func:`global_batch` (no gradient), else this process's."""
    ctx = active()
    return mask.sum() if ctx is None else ctx.mask_sum(mask)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``t`` over the active group (``t`` itself
    outside :func:`global_batch`): the backward all-reduces the incoming
    gradient, so each rank receives the cross-rank terms of a statistic
    every rank's loss depends on."""
    ctx = active()
    if ctx is None:
        return t
    return _AllReduceSum.apply(t, ctx.group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the gradient of a sum is the sum of the ranks'
    gradients, so the backward all-reduces too."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_grads(params) -> None:
    """Sum the ``.grad`` of ``params`` over the active group in place, in
    one flat buffer (nothing outside :func:`global_batch`).  A parameter
    without a gradient has none on every rank (the graph is the same) and
    is left out."""
    ctx = active()
    if ctx is None:
        return
    import torch.distributed as dist
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=ctx.group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def broadcast_state(tensors) -> None:
    """Overwrite ``tensors`` in place with rank 0's values, one flat buffer
    per dtype (no-op without a process group)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src=0)
        offset = 0
        with torch.no_grad():
            for t in ts:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n


def sum_metrics(metrics: dict) -> dict:
    """``metrics`` (0-dim tensors) summed over the active group in one
    all-reduce (themselves outside :func:`global_batch`).  Each rank's term
    of a masked mean is its share of the global mean, so every rank then
    holds the global values."""
    ctx = active()
    if ctx is None or not metrics:
        return metrics
    import torch.distributed as dist
    values = torch.stack(list(metrics.values()))
    dist.all_reduce(values, group=ctx.group)
    return dict(zip(metrics, values.unbind()))
