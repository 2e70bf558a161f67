"""Tensor parallelism: the model group's collectives, and the sharded
layers' plan.

a2m shards the UNet bottleneck pair and the discriminator's conv3 pair with
``TP_RULES`` (:mod:`a2m_torch.parallel.mesh`) and lets GSPMD insert the
collectives.  The port runs one process a rank and writes them out,
Megatron's way, as autograd functions over the ranks of one model group
(the ranks that share a batch and hold different channel slices):

* :func:`copy_to_model`: identity forward, all-reduce backward: the input
  of a column-parallel layer (and a replicated tensor each rank uses on its
  own channels), whose gradient is the sum of the ranks' parts;
* :func:`reduce_from_model`: all-reduce forward, identity backward: the
  partial products of a row-parallel layer;
* :func:`reduce_scatter_channels`: reduce-scatter forward on the channel
  axis, all-gather backward: the attention's value, each rank keeping its
  own channels of the summed product.

The sums run in at least f32 (a bf16 partial product is promoted first).
:func:`dropout` draws a mask at the full channel width and takes the rank's
slice, so the ranks of a model group stay in step on the generator and
drop what one process would drop.

A sharded layer sets :class:`Shard` as its ``tp`` and slices its own
tensors (``shard_``, :func:`a2m_torch.parallel.mesh.shard_module`); the
model then carries a :class:`Plan`: which entries of its ``state_dict`` are
sliced on which dimension, and which replicated parameters each rank uses
on its channel slice only (their gradients are partial sums, added over
the model group by the train steps, :func:`sum_partial_grads`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Shard:
    """This rank's place in its model group: ``rank`` of ``size``."""
    group: object
    rank: int
    size: int

    def part(self, n: int) -> slice:
        """This rank's slice of ``n`` channels; raises unless ``size``
        divides ``n``."""
        if n % self.size:
            raise ValueError(f'{self.size} model ranks do not divide {n} '
                             f'channels')
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


@dataclass
class Plan:
    """What :func:`~a2m_torch.parallel.mesh.shard_module` did to a model:
    ``state`` maps a ``state_dict`` key to the dimension sliced there,
    ``partial`` names the replicated parameters whose gradient each rank
    holds only on its channels."""
    shard: Shard
    state: dict[str, int] = field(default_factory=dict)
    partial: list[str] = field(default_factory=list)


def plan_of(model) -> Plan | None:
    """The :class:`Plan` of a sharded model, else None."""
    return getattr(model, 'tp_plan', None)


def sum_partial_grads(model) -> None:
    """Sum over the model group, in one flat all-reduce, the gradients of
    a sharded ``model``'s ``Plan.partial`` parameters: replicated, but
    each rank used them on its channel slice only, so it holds its
    channels' part of their gradient.  Every other replicated parameter
    has its whole gradient on each rank, the same bits on every rank of
    the group (each computes the same replicated activations, and
    :func:`~a2m_torch.parallel.mesh.make_mesh` turns on torch's
    deterministic algorithms); a sliced one has its rank's own.  Nothing
    for an unsharded model."""
    import torch.distributed as dist
    plan = plan_of(model)
    if plan is None:
        return
    named = dict(model.named_parameters())
    grads = [named[k].grad for k in plan.partial
             if named[k].grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=plan.shard.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _promoted(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.promote_types(t.dtype, torch.float32)).contiguous()


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=group)
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.shard.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return _all_reduce(_promoted(x), shard.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ReduceScatterChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        import torch.distributed as dist
        ctx.shard = shard
        x = _promoted(x)
        n = shard.size
        # rank r's channels first in rank order: (n, ..., C / n) contiguous
        parts = x.reshape(*x.shape[:-1], n, x.shape[-1] // n).movedim(-2, 0)
        out = x.new_empty(parts.shape[1:])
        dist.reduce_scatter_tensor(out.view(-1), parts.reshape(-1),
                                   group=shard.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return gather_channels(grad, ctx.shard, -1), None


def copy_to_model(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the model group."""
    return _CopyToModel.apply(x, shard)


def reduce_from_model(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` (in at least f32); the gradient
    passes unchanged to every rank."""
    return _ReduceFromModel.apply(x, shard)


def reduce_scatter_channels(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """This rank's channels (last axis) of the sum of the ranks' ``x``;
    the gradient is gathered back to the full width."""
    return _ReduceScatterChannels.apply(x, shard)


def gather_channels(t: torch.Tensor, shard: Shard, dim: int
                    ) -> torch.Tensor:
    """The ranks' slices of ``t`` concatenated along ``dim``, in rank order
    (no gradient)."""
    import torch.distributed as dist
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t, group=shard.group)
    return torch.cat(parts, dim=dim)


def dropout(x: torch.Tensor, p: float, training: bool, shard: Shard
            ) -> torch.Tensor:
    """``F.dropout`` of this rank's channels (last axis) of a full-width
    tensor: the mask is drawn at the full width, in the memory layout
    ``x`` has (channel-last, or a convolution's channel-first output seen
    channel-last), and sliced."""
    if not training or p == 0.0:
        return x
    c = x.shape[-1] * shard.size
    if x.dim() < 3 or x.is_contiguous():
        ones = x.new_ones(*x.shape[:-1], c)
    else:
        ones = x.new_ones(x.shape[0], c, *x.shape[1:-1]).movedim(1, -1)
    return x * F.dropout(ones, p, True)[..., shard.part(c)]
