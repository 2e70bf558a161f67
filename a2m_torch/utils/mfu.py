"""Model-FLOPs utilisation of the train steps (``a2m/utils/mfu.py``).

a2m takes a step's FLOPs from XLA's cost analysis of the compiled step.
The port runs eagerly, so :func:`step_flops` counts the operations of one
real call: the aten operations through ``torch.utils.flop_counter``, plus
the fused GCN stack kernels, which launch through ctypes on raw pointers
and which the counter therefore does not see.  Each stack launch adds the
kernel's own cost function (``gcn_kernel.stack_flops`` for a forward, K1,
K3 or K5; ``gcn_kernel.stack_bwd_flops`` for a backward, K4, which
recomputes the forward), read off the wrappers' launch counters around the
call.  The speech tower's attention kernel (K6, ``nn/rel_attention.py``)
is a CUDA launch the counter does not see either: each launch adds its
QK^T and PV (``rel_attention_flops``, kept on ``rel_attention.flops``).
On the CPU the stacks and K6 run their plain versions, which the counter
sees, and no launch is added.

In a data-parallel run every number is per rank: a rank's step over its
own rows of the global batch, timed on its own clock (the collectives
included), against the peak of one card; the trainer of rank 0 logs the
line, marked ``per rank of N``.  Ranks that share one card each count the
whole card's peak.

Peaks are the published dense rates of one card (NVIDIA's H100 SXM data
sheet: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 outside
them); the CPU's 1e11 only keeps the numbers finite in tests.
"""

from __future__ import annotations

import torch

#: published peak FLOP/s by (device kind, compute dtype)
PEAK_FLOPS = {
    ('h100', 'bf16'): 989e12,
    ('h100', 'f32'): 67e12,
    ('cpu', 'bf16'): 1e11,
    ('cpu', 'f32'): 1e11,
}


def device_kind(device='cuda') -> str:
    """'h100' for any H100, the lower-case card name for another card,
    'cpu' for the CPU."""
    dev = torch.device(device)
    if dev.type != 'cuda':
        return 'cpu'
    name = torch.cuda.get_device_name(dev).lower()
    return 'h100' if 'h100' in name else name


def peak_flops(dtype: str = 'f32', device='cuda') -> float | None:
    """The card's published peak for ``dtype``; None for a card the table
    does not hold."""
    return PEAK_FLOPS.get((device_kind(device), dtype))


_STACK_WRAPPERS = ('gcn_stack', 'gcn_stack_fwd', 'gcn_stack_edge',
                   'gcn_stack_bwd')


def _launches() -> dict[str, int]:
    from a2m_torch.nn import gcn_kernel
    return {name: getattr(gcn_kernel, name).launches
            for name in _STACK_WRAPPERS}


def step_flops(fn, *args, **kwargs) -> tuple[object, float]:
    """Run ``fn(*args, **kwargs)`` once and count its operations: the aten
    operations it dispatches, and the fused GCN stack kernels and K6
    launches it makes.
    Returns (the call's result, the operations).  The stacks are found by
    forward hooks on every :class:`~a2m_torch.nn.graph.GCNStack` during the
    call; each launch adds its kernel's cost at the stack's shape (N graphs
    of J joints, F features, H heads, L layers), and the launches must
    match the fused stacks that ran on the card."""
    from torch.utils.flop_counter import FlopCounterMode

    from a2m_torch.nn import gcn_kernel
    from a2m_torch.nn.graph import GCNStack
    from a2m_torch.nn.rel_attention import rel_attention

    runs: list[tuple] = []          # (shape args of the cost, under grad)

    def record(module, inputs):
        x = inputs[0]
        if not (module.fused and x.is_cuda):
            return                  # the eager layers or the plain version
        j, f = x.shape[-2], x.shape[-1]
        grad = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad
                                   for p in module.parameters()))
        runs.append(((x.numel() // (j * f), module.adjacency, f,
                      module.heads, module.num_layers), grad))

    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, inputs: record(m, inputs) if isinstance(m, GCNStack)
        else None)
    before = _launches()
    k6_before = rel_attention.flops
    try:
        with FlopCounterMode(display=False) as counter:
            out = fn(*args, **kwargs)
    finally:
        hook.remove()
    after = _launches()
    launched = {k: after[k] - before[k] for k in after}
    total = float(counter.get_total_flops()) + (rel_attention.flops
                                                 - k6_before)
    forwards = launched['gcn_stack'] + launched['gcn_stack_fwd'] + \
        launched['gcn_stack_edge']
    backwards = [shape for shape, grad in runs if grad]
    if forwards != len(runs) or launched['gcn_stack_bwd'] != len(backwards):
        raise RuntimeError(
            f'stack launches {launched} for {len(runs)} fused stack calls on '
            f'the card, {len(backwards)} of them under autograd')
    for n, adj, f, heads, layers in (shape for shape, _ in runs):
        total += gcn_kernel.stack_flops(n, adj.cpu(), f, heads, layers)
    for n, adj, f, heads, layers in backwards:
        total += gcn_kernel.stack_bwd_flops(n, adj.cpu(), f, heads, layers)
    return out, total


def mfu(flops_per_step: float, step_seconds: float, dtype: str = 'f32',
        device='cuda') -> float | None:
    """Achieved fraction of the peak: flops / (peak * seconds); None when
    the card's peak is not in the table."""
    peak = peak_flops(dtype, device)
    if peak is None or step_seconds <= 0:
        return None
    return flops_per_step / (peak * step_seconds)


def format_mfu_line(name: str, flops_per_step: float, step_seconds: float,
                    dtype: str = 'f32', device='cuda', ranks: int = 1) -> str:
    """The trainer's MFU line; with ``ranks`` > 1 it ends ``per rank of
    <ranks>`` (the step, its operations and its time are one rank's)."""
    tf = flops_per_step / 1e12
    achieved = flops_per_step / step_seconds / 1e12
    line = (f'{name}: {step_seconds * 1e3:.1f} ms/step, {tf:.2f} TFLOP, '
            f'{achieved:.1f} TFLOP/s achieved, ')
    util = mfu(flops_per_step, step_seconds, dtype, device)
    if util is None:
        line += (f'MFU not known (no {dtype} peak for '
                 f'{device_kind(device)!r})')
    else:
        line += (f'MFU {100 * util:.1f}% ({device_kind(device)} {dtype} '
                 f'peak {peak_flops(dtype, device) / 1e12:.3g} TF/s)')
    return line + (f', per rank of {ranks}' if ranks > 1 else '')
