"""CUDA graphs of the train steps: each step kind (``g_step``, ``d_step``)
is captured once per input signature and replayed for every later step of
that kind, so that a step costs the host a few launches instead of issuing
G's and D's forward, the autograd engine's backward and Adam kernel by
kernel.

A graph holds the whole step as :func:`~a2m_torch.train.train_step.
make_train_steps` builds it: the forward passes, the losses, ``backward()``
and Adam, the hand-written GCN kernels among them (they launch on the
current stream, which capture records).  The same kernels run in the same
order as in an eager step.  The controller stays on the host: it picks the
graph by calling the step, and its per-epoch values reach the graph as
device tensors (the label parameters here, the learning rates through
``set_lr``).  Label noise draws from the step's ``torch.Generator``, which
each graph registers (a replay advances it as an eager step does), dropout
from the device's default generator.

When graphs apply (:func:`applies`): on a CUDA device with no process
group up; the data- and tensor-parallel ranks, whose collectives are out of
scope, and the CPU run the eager step.  A ``g_step`` runs eager on the
first call of a signature (its warm-up, and a real step) and captures on
the second; a ``d_step`` captures on its first (Adam's state is created
first as a fresh Adam makes it).  A capture is followed by one replay, so
each call is exactly one step, and a replay adds the hand-written
kernels' launches it makes to their counters.  Under an operation counter
(``FlopCounterMode``) a step with a graph runs eagerly, so that its
operations are seen.  A graph is dropped, and captured again, when the
models, the optimisers, their state or parameter groups, the label
generator or the pose statistics it captured are replaced (a restore
replaces the optimisers' state; ``load_state_dict`` on a module copies
in place and keeps the graph).

A capture needs what any CUDA graph of a backward needs: no autograd
graph of the models' parameters kept alive from outside the step (a
clone of a parameter made under autograd holds one), since its gradient
accumulators would then belong to the default stream and the capture
fails.

A replay writes parameters, BatchNorm statistics and Adam's moments
without Python, so their ``_version`` would stand still; the caches keyed
on it (``GCNStack.packed_params``, and through it ``gcn_kernel.
edge_tc_weights``) would then serve eager code stale packs.  Every tensor a
graph writes has its version bumped before a capture (no earlier cache
entry is captured as a constant) and after every replay.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import torch

from a2m_torch.nn import gcn_kernel
from a2m_torch.utils.profiling import trace_annotation

#: eager calls of a signature before its capture, by step kind
EAGER_CALLS = {'g': 1, 'd': 0}
#: the hand-written kernels' launch counters (``gcn_kernel.<name>.launches``)
COUNTED = ('gcn_stack', 'gcn_stack_fwd', 'gcn_stack_bwd', 'gcn_stack_edge')


def _launch_counts() -> dict[str, int]:
    return {name: getattr(gcn_kernel, name).launches for name in COUNTED}


def applies(device) -> bool:
    """Whether the train steps run as CUDA graphs on ``device``: a CUDA
    device, no process group up, and no capture under way already."""
    import torch.distributed as dist
    return (torch.device(device).type == 'cuda'
            and not (dist.is_available() and dist.is_initialized())
            and not (torch.cuda.is_available()
                     and torch.cuda.is_current_stream_capturing()))


def _counting() -> bool:
    """Whether a dispatch mode watches the operations (``FlopCounterMode``,
    as ``utils.mfu.step_flops`` and the benchmark count a step): a replay
    dispatches none, so such a step runs eagerly (a capture dispatches
    them all, and may run under one)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    return _get_current_dispatch_mode() is not None


def capture(fn, pool, generator):
    """Capture ``fn()`` on a CUDA graph in the memory ``pool`` (None: a new
    one), with ``generator``'s draws registered.  Returns (replay, fn's
    result, the graph's pool)."""
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    with torch.cuda.graph(graph, pool=pool, capture_error_mode='thread_local'):
        out = fn()
    return graph.replay, out, graph.pool()


def fresh_adam_state(optimizer) -> None:
    """The state a fresh capturable Adam makes at its first step (step 0
    on the device, zero moments), for every trainable parameter that has
    none: a capture must not allocate it, or each replay would reset it."""
    from torch.optim.optimizer import _get_scalar_dtype
    for group in optimizer.param_groups:
        for p in group['params']:
            if p.requires_grad and not optimizer.state.get(p):
                optimizer.state[p] = {
                    'step': torch.zeros((), dtype=_get_scalar_dtype(),
                                        device=p.device),
                    'exp_avg': torch.zeros_like(
                        p, memory_format=torch.preserve_format),
                    'exp_avg_sq': torch.zeros_like(
                        p, memory_format=torch.preserve_format)}


@dataclasses.dataclass
class _Graph:
    """One captured step: its replay, static inputs (None where the step
    got None), label tensors and their host values, the states and
    metrics it returns, what it captured (``owners``, compared by
    identity), the tensors it writes (their addresses at capture must
    hold) and the kernel launches a replay makes, by counter."""
    replay: object
    inputs: list
    labels: list
    values: list
    states: tuple
    metrics: dict
    owners: tuple
    written: list
    launches: dict

    def __post_init__(self):
        self.addresses = [t.data_ptr() for t in self.written]

    def holds(self, owners) -> bool:
        return (len(owners) == len(self.owners)
                and all(a is b for a, b in zip(owners, self.owners))
                and [t.data_ptr() for t in self.written] == self.addresses)


class GraphedStep:
    """A train step (``g_step`` or ``d_step`` of ``make_train_steps``) that
    runs as a CUDA graph where :func:`applies` says so, and as itself
    elsewhere.  Called as the step is.  ``pool`` is a list shared by the
    kinds, holding the graphs' one memory pool once the first capture made
    it.  ``eager = True`` keeps every call eager (tests compare the two)."""

    def __init__(self, step, kind: str, pool: list):
        functools.update_wrapper(self, step)
        self.step, self.kind, self.pool = step, kind, pool
        self.span = f'a2m.{kind}_step.replay'
        self.eager = False
        #: input signature -> its graph
        self.graphs: dict = {}
        self._calls: collections.Counter = collections.Counter()

    def __call__(self, g_state, d_state, audio, pose, mean, std, *rest,
                 style=None, mask=None):
        *labels, key = rest
        stepped = g_state if self.kind == 'g' else d_state
        if (self.eager or not applies(audio.device)
                or not all(group.get('capturable')
                           for group in stepped.optimizer.param_groups)):
            return self.step(g_state, d_state, audio, pose, mean, std, *rest,
                             style=style, mask=mask)
        sig = tuple(None if t is None else (tuple(t.shape), t.dtype, t.device)
                    for t in (audio, pose, style, mask, mean, std))
        owners = self._owners(g_state, d_state, key, mean, std)
        rec = self.graphs.get(sig)
        if rec is not None and not rec.holds(owners):
            del self.graphs[sig]
            rec = None
        if rec is not None and _counting():
            return self.step(g_state, d_state, audio, pose, mean, std, *rest,
                             style=style, mask=mask)
        if rec is None:
            if self._calls[sig] < EAGER_CALLS[self.kind]:
                self._calls[sig] += 1
                return self.step(g_state, d_state, audio, pose, mean, std,
                                 *rest, style=style, mask=mask)
            rec = self.graphs[sig] = self._capture(
                g_state, d_state, audio, pose, mean, std, labels, key, style,
                mask, owners)
        else:
            # the counters count a replay's launches as a step's (the
            # capture's wrappers counted those of the replay that follows)
            for name, n in rec.launches.items():
                getattr(gcn_kernel, name).launches += n
        with trace_annotation(self.span):
            for static, t in zip(rec.inputs, (audio, pose, style, mask)):
                if static is not None:
                    static.copy_(t)
            for i, value in enumerate(labels):
                if float(value) != rec.values[i]:
                    rec.labels[i].fill_(value)
                    rec.values[i] = float(value)
            rec.replay()
            torch.autograd.graph.increment_version(rec.written)
            metrics = {k: v.clone() for k, v in rec.metrics.items()}
        return (*rec.states, metrics)

    def _owners(self, g_state, d_state, key, mean, std) -> tuple:
        """What a graph captures and must find again to be replayed."""
        opts = (g_state.optimizer, d_state.optimizer)
        return (g_state.model, d_state.model, *opts,
                *(o.state for o in opts), *(o.param_groups for o in opts),
                *(group['lr'] for o in opts for group in o.param_groups),
                key, mean, std)

    def _capture(self, g_state, d_state, audio, pose, mean, std, labels,
                 key, style, mask, owners) -> _Graph:
        stepped = g_state if self.kind == 'g' else d_state
        fresh_adam_state(stepped.optimizer)
        inputs = [None if t is None else t.clone()
                  for t in (audio, pose, style, mask)]
        static = [torch.full((), float(v), device=audio.device)
                  for v in labels]
        written = [*g_state.model.state_dict(keep_vars=True).values(),
                   *d_state.model.state_dict(keep_vars=True).values(),
                   *(t for s in stepped.optimizer.state.values()
                     for t in s.values() if isinstance(t, torch.Tensor))]
        torch.autograd.graph.increment_version(written)
        a, b, s, m = inputs
        before = _launch_counts()
        replay, out, pool = capture(
            lambda: self.step(g_state, d_state, a, b, mean, std, *static,
                              key, style=s, mask=m),
            self.pool[0] if self.pool else None, key)
        self.pool[:] = [pool]
        launches = {k: n - before[k] for k, n in _launch_counts().items()
                    if n != before[k]}
        return _Graph(replay, inputs, static, [float(v) for v in labels],
                      out[:2], out[2], owners, written, launches)
