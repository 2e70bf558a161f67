"""The (data, model) grid of ranks: splitting the data, the global batch
the train steps compute over, and tensor parallelism's rules.

Counterpart of ``a2m/parallel/mesh.py``: ``make_mesh`` (``:30``, here over
the ranks of a process group), ``TP_RULES``, ``param_spec`` and
``param_shardings`` (``:54-98``, on the port's modules and the torch layout
of their weights), ``host_interval_slice`` and ``balanced_host_slices``
(``:145-186``), the process identity they are used with, and the global
batch that stands in for ``make_sharded_train_steps`` (``:188-227``): the
port's own train steps run inside it.  a2m's ``shard_batch``,
``replicate_states``, ``global_put``, ``batch_sharding`` and ``replicated``
place arrays on a mesh of devices; here they are the loader's slices (each
data rank reads its own) and :func:`broadcast_state`.

In a2m a multi-process run is one global program over a mesh: the
BatchNorm moments, the losses and so the gradients are taken over the
global batch, and GSPMD inserts the gradient psum.  The port runs one
process per card, each on its own slice of the batch, and reproduces that
with explicit collectives inside :func:`global_batch`, over the ranks of
one data group (the ranks that hold the same channels):

* ``MaskedBatchNorm`` (train mode) all-reduces its masked sums, so its
  moments and running statistics are the concatenated batch's, and the
  reductions are differentiable (their backward all-reduces too);
* ``losses.masked_mean`` divides each rank's sum by the global mask sum,
  so the ranks' terms add up to a2m's global loss;
* the steps (:func:`a2m_torch.train.train_step.make_train_steps`, which
  enter the context whenever a process group is up) all-reduce (sum) the
  gradients before clipping and Adam, in one flat buffer a model, and
  return the global sums of their metrics;
* label noise is drawn at the global batch's shape and each data rank
  takes its own rows.

**Tensor parallelism.**  :func:`make_mesh` lays the ranks out as a2m lays
out its devices, ``reshape(data, model)``: rank ``r`` has data index
``r // model`` and model index ``r % model``, so a model group is
consecutive ranks.  Under ``TP_RULES`` (:func:`shard_module`) each rank of
a model group holds its slice of the UNet's bottleneck convolution
(column-parallel: its output channels), of the bottleneck attention's
query, key and value and of ``up0`` (row-parallel: their input channels),
and the same of the discriminator's ``conv3b``, ``conv3_attn`` and
``conv3c``; the sharded layers run the model group's collectives of
:mod:`a2m_torch.parallel.tensor`.  Everything else, the GCN stacks
included, is replicated, and stays bit-equal across a model group
because each rank computes it alike (torch's deterministic algorithms,
switched on by :func:`make_mesh`).  :func:`gather_state` puts the slices
back together, so that checkpoints keep the one-process layout.  One
process over several devices stays refused (``config.validate``): torch
runs one process a card.
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


# ---- the grid of ranks ------------------------------------------------------

class Mesh:
    """The (data, model) grid over the ranks of the process group, and this
    rank's groups: ``data_group`` (the ranks of its model index, one a data
    index), ``model_group`` (the ranks of its data index; None when
    ``model`` is 1) and ``host_data_group`` (the data group on gloo, for
    host-side sums)."""

    def __init__(self, data: int, model: int, rank: int, data_group,
                 model_group, host_data_group):
        self.data, self.model, self.rank = data, model, rank
        self.data_group, self.model_group = data_group, model_group
        self.host_data_group = host_data_group

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def shard(self):
        """This rank's :class:`~a2m_torch.parallel.tensor.Shard` of its
        model group (None without tensor parallelism)."""
        from a2m_torch.parallel.tensor import Shard
        if self.model_group is None:
            return None
        return Shard(self.model_group, self.model_rank, self.model)

    def __repr__(self) -> str:
        return (f'Mesh({self.data}x{self.model}, rank {self.rank}: data '
                f'{self.data_rank}, model {self.model_rank})')


#: the grid make_mesh built for the current process group
_grid: Mesh | None = None


def mesh_shape(cfg, world: int) -> tuple[int, int]:
    """(data, model) of a ``MeshConfig`` over ``world`` ranks: ``data=-1``
    takes what ``model`` leaves (a2m's ``resolved_shape``), and the default
    1 x 1 in a group of several ranks is data-parallel over all of them
    (a2m's ``loop.py:104-106``)."""
    data, model = cfg.resolved_shape(world)
    if data * model == 1:
        data = world
    return data, model


def make_mesh(cfg):
    """The (data, model) grid of ``cfg`` (a ``MeshConfig``) over the ranks of
    the process group, laid out row-major as a2m's
    ``np.asarray(devices).reshape(data, model)``; None without a group.
    Every rank creates every group, in the same order.  With a model axis
    it also turns on torch's deterministic algorithms
    (:func:`set_deterministic`), so that the ranks of a model group keep
    their replicated parameters bit-equal without exchanging them.  The
    grid is this process's from then on (:func:`current_mesh`) until the
    group is destroyed (``launch.shutdown``)."""
    global _grid
    import torch.distributed as dist

    from a2m_torch.parallel import launch
    if not (dist.is_available() and dist.is_initialized()):
        return None
    rank, world = dist.get_rank(), dist.get_world_size()
    data, model = mesh_shape(cfg, world)
    if data * model != world:
        raise ValueError(f'mesh {data}x{model} != {world} devices; set '
                         f'mesh.data/-1 or mesh.model')
    old = current_mesh()
    if old is not None and (old.data, old.model) == (data, model):
        return old
    host = launch.host_group()
    if model > 1:
        # the ranks of a model group compute the replicated parameters'
        # gradients each on its own, and must get the same bits: cuDNN's
        # backward convolutions, among others, add with atomics otherwise
        set_deterministic(True)
    if model == 1:
        grid = Mesh(data, model, rank, dist.group.WORLD, None, host)
    else:
        import datetime
        timeout = datetime.timedelta(seconds=launch.TIMEOUT_S)
        gloo = dist.get_backend() == 'gloo'

        def groups(members, backend=None):
            made = [dist.new_group(m, timeout=timeout, backend=backend)
                    for m in members]
            return next(g for g, m in zip(made, members) if rank in m)

        by_data = [list(range(i * model, (i + 1) * model))
                   for i in range(data)]
        by_model = [list(range(j, world, model)) for j in range(model)]
        model_group, data_group = groups(by_data), groups(by_model)
        host_data = data_group if gloo else groups(by_model, 'gloo')
        grid = Mesh(data, model, rank, data_group, model_group, host_data)
    _grid = grid
    return grid


def set_deterministic(on: bool) -> None:
    """torch's deterministic algorithms, cuDNN's among them, on or off (an
    operation that has none warns).  Fresh tensors stay unfilled
    (``fill_uninitialized_memory``): the port reads none before writing
    it, and the fills would cost a launch each."""
    import torch.utils.deterministic
    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False


def current_mesh() -> Mesh | None:
    """The grid :func:`make_mesh` built for the live process group, or
    None."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return _grid


def clear_mesh() -> None:
    """Forget the grid (its groups die with the process group)."""
    global _grid
    _grid = None


def data_identity() -> tuple[int, int]:
    """(data rank, data size) of this process: what the loader's slices
    and the label noise's rows follow.  Without a grid, the process
    group's (rank, world size); in one process (0, 1)."""
    grid = current_mesh()
    if grid is None:
        return process_identity()
    return grid.data_rank, grid.data


def host_interval_slice(intervals: list, process_index: int | None = None,
                        process_count: int | None = None) -> list:
    """Stride ``intervals`` across data ranks: rank ``i`` of ``n`` takes
    ``intervals[i::n]``.  Striding balances interval counts, not window
    counts: the data loader uses :func:`balanced_host_slices`."""
    rank, world = data_identity()
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
    ``process_count`` None is the data size of :func:`data_identity`.
    """
    pc = process_count if process_count is not None else data_identity()[1]
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
    the data group (all ranks without tensor parallelism), as a2m's one
    global program does.  Without a process group
    it changes nothing.  The train steps run inside it (used as their
    decorator)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        yield
        return
    grid = current_mesh()
    group = dist.group.WORLD if grid is None else grid.data_group
    token = _group_var.set(_GlobalBatch(group))
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
    one flat buffer (nothing outside :func:`global_batch`, or over a group
    of one rank: one data rank of a tensor-parallel grid).  A parameter
    without a gradient has none on every rank (the graph is the same) and
    is left out."""
    ctx = active()
    if ctx is None or ctx.world == 1:
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


# ---- tensor parallelism: the rules and the sharded state --------------------

#: a2m's ``TP_RULES`` (``a2m/parallel/mesh.py:54-63``): (regex on the a2m
#: path ``params/<scope>/<leaf>`` of a parameter, a2m's PartitionSpec of its
#: flax layout); the first match wins, the spec aligned to trailing axes
TP_RULES: list[tuple[str, tuple]] = [
    # UNet bottleneck pair: 1024 -> 2048 sharded on out, consumer on in
    (r'unet/bottleneck/conv/kernel', (None, None, 'model')),
    (r'unet/bottleneck_attention/(query|key|value)/kernel', ('model', None)),
    (r'unet/up0/kernel', (None, 'model', None)),
    # discriminator conv3 pair (512 -> 1024 -> 2048)
    (r'conv3b/conv/kernel', (None, None, 'model')),
    (r'conv3_attn/(query|key|value)/kernel', ('model', None)),
    (r'conv3c/conv/kernel', (None, 'model', None)),
]


def a2m_spec(path: str, ndim: int) -> tuple:
    """a2m's ``param_spec``: the PartitionSpec (a tuple of axis names or
    None, one per axis of the flax layout) of the parameter at a2m path
    ``path``; all None when no rule of ``TP_RULES`` matches."""
    import re
    for pattern, spec in TP_RULES:
        if re.search(pattern, path):
            spec = tuple(spec)[-ndim:]
            return (None,) * (ndim - len(spec)) + spec
    return (None,) * ndim


def param_spec(model, name: str) -> int | None:
    """The dimension of ``model``'s parameter ``name`` (a torch layout) that
    ``TP_RULES`` shard over the model axis, or None (replicated): a2m's
    spec of the parameter's a2m path, taken through the layout transpose of
    :mod:`a2m_torch.weights`."""
    from a2m_torch.weights import jax_key
    path, axes = jax_key(model, name)
    ndim = model.get_parameter(name).dim()
    spec = a2m_spec(path, ndim)
    if 'model' not in spec:
        return None
    a2m_axis = spec.index('model')
    return a2m_axis if axes is None else axes[a2m_axis]


def param_shardings(model) -> dict[str, int | None]:
    """Every parameter of ``model`` -> its sharded dimension or None
    (a2m's ``param_shardings``, on the unsharded module)."""
    return {name: param_spec(model, name)
            for name, _ in model.named_parameters()}


def shard_module(model):
    """Slice ``model`` (built whole, the same on every rank) to this rank's
    part of the current grid's model group under ``TP_RULES``: each layer
    that owns a sharded parameter (``ConvNormRelu``, the discriminator's
    conv unit, ``SelfAttention``, ``ConvTranspose1D``) keeps its channels
    and runs the model group's collectives.  Returns the model, which
    carries its :class:`~a2m_torch.parallel.tensor.Plan` as ``tp_plan``;
    without a model axis nothing changes.  Build the optimiser after this:
    it must hold the sliced tensors."""
    from a2m_torch.parallel.tensor import plan_of
    grid = current_mesh()
    shard = None if grid is None else grid.shard()
    if shard is None or plan_of(model) is not None:
        return model
    model.tp_plan = _slice_layers(model, shard)
    return model


def check_shardable(cfg) -> None:
    """Slice the generator and discriminator of ``cfg`` (a ``Config``),
    built on the meta device, as :func:`shard_module` slices the real ones
    over ``cfg.mesh.model`` ranks: raises what that would raise (a sharded
    width the model axis does not divide, a layer that has no sharded
    mode), naming the leaf.  ``config.validate`` calls it."""
    from a2m_torch.models.discriminator import Discriminator
    from a2m_torch.models.generator import Generator
    from a2m_torch.parallel.tensor import Shard
    with torch.device('meta'):
        models = (Generator(cfg.generator), Discriminator(cfg.discriminator))
    for model in models:
        _slice_layers(model, Shard(None, 0, cfg.mesh.model))


def _slice_layers(model, shard):
    """Slice the layers of ``model`` that own a parameter ``TP_RULES``
    shard to ``shard``'s part; returns their
    :class:`~a2m_torch.parallel.tensor.Plan`."""
    from a2m_torch.parallel.tensor import Plan
    dims = {k: v for k, v in param_shardings(model).items()
            if v is not None}
    for k, dim in dims.items():
        width = model.get_parameter(k).shape[dim]
        if width % shard.size:
            raise ValueError(f'mesh.model={shard.size} does not divide the '
                             f'{width} channels that TP_RULES split at {k}')
    plan = Plan(shard)
    done: list[str] = []
    for prefix, layer in model.named_modules():
        if not hasattr(layer, 'shard_') or any(
                prefix.startswith(p + '.') for p in done):
            continue
        head = prefix + '.' if prefix else ''
        own = {k[len(head):]: d for k, d in dims.items()
               if k.startswith(head)}
        if not own:
            continue
        try:
            state, partial = layer.shard_(shard, own)
        except ValueError as e:
            raise ValueError(f'{prefix}: {e}') from e
        plan.state.update({head + k: d for k, d in state.items()})
        plan.partial.extend(head + k for k in partial)
        done.append(prefix)
    missed = sorted(set(dims) - set(plan.state))
    if missed:
        raise ValueError(f'TP_RULES shard {missed}, which no sharded layer '
                         f'owns')
    return plan


def gather_state(model) -> dict:
    """``model.state_dict()`` in the one-process layout: each sliced entry
    gathered from the ranks of the model group (every rank takes part and
    gets the whole)."""
    from a2m_torch.parallel.tensor import gather_channels, plan_of
    plan = plan_of(model)
    state = model.state_dict()
    if plan is None:
        return state
    return {k: (gather_channels(v, plan.shard, plan.state[k])
                if k in plan.state else v) for k, v in state.items()}


def _slice(t: torch.Tensor, shard, dim: int) -> torch.Tensor:
    part = shard.part(t.shape[dim])
    return t.narrow(dim, part.start, part.stop - part.start).clone()


def load_full_state(model, state: dict) -> None:
    """Load a one-process ``state_dict`` into ``model``, each sliced entry
    cut to this rank's part."""
    from a2m_torch.parallel.tensor import plan_of
    plan = plan_of(model)
    if plan is not None:
        state = {k: (_slice(v, plan.shard, plan.state[k])
                     if k in plan.state else v) for k, v in state.items()}
    model.load_state_dict(state)


def _param_names(optimizer, model) -> list[str]:
    """The name in ``model`` of each parameter ``optimizer`` holds, in the
    order of its ``state_dict``."""
    names = {id(p): k for k, p in model.named_parameters()}
    return [names[id(p)] for group in optimizer.param_groups
            for p in group['params']]


def gather_optimizer_state(optimizer, model) -> dict:
    """``optimizer.state_dict()`` in the one-process layout: the moments of
    each sliced parameter gathered from the model group."""
    from a2m_torch.parallel.tensor import gather_channels, plan_of
    state = optimizer.state_dict()
    plan = plan_of(model)
    if plan is None:
        return state
    names = _param_names(optimizer, model)
    moments = {}
    for i, entry in state['state'].items():
        dim = plan.state.get(names[i])
        moments[i] = {k: (gather_channels(v, plan.shard, dim)
                          if dim is not None and v.dim() else v)
                      for k, v in entry.items()}
    return dict(state, state=moments)


def load_full_optimizer_state(optimizer, model, state: dict) -> None:
    """Load a one-process ``optimizer.state_dict()``, the moments of each
    sliced parameter cut to this rank's part."""
    from a2m_torch.parallel.tensor import plan_of
    plan = plan_of(model)
    if plan is not None:
        names = _param_names(optimizer, model)
        moments = {}
        for i, entry in state['state'].items():
            dim = plan.state.get(names[int(i)])
            moments[i] = {k: (_slice(v, plan.shard, dim)
                              if dim is not None and v.dim() else v)
                          for k, v in entry.items()}
        state = dict(state, state=moments)
    optimizer.load_state_dict(state)
