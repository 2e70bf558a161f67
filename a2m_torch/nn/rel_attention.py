"""K6: attention with a gated relative-position bias (WavLM's), fused.

Replaces no TPU kernel: the JAX package has no speech tower.  It was added
for :mod:`a2m_torch.nn.wavlm`, whose every layer computes, per stream b and
head h,

    S[t, s] = q[t] . k[s] * scale + g[b, h, t] * E[h, s - t + T - 1]
    out[t]  = softmax_s(S[t, :]) @ v

with ``E`` the (H, 2T - 1) table of the layer-0 embedding read at the T5
bucket of every offset s - t, and ``g`` a gate per query.  Written out as
the published code writes it, the bias is a (B * H, T, T) tensor: 4.6 GB in
f32 a layer for 8 streams of 60 s (T = 2,999).

:func:`rel_attention` on CUDA tensors launches ``csrc/rel_attention.cu``, a
flash-attention forward in CUDA C++: a block of 128 queries walks over key
steps of 64, QK^T and PV on the tensor cores (``mma.sync``, bf16 operands,
f32 sums, P rounded to bf16 for its product), the online softmax in f32 and
base 2, and the bias read inside the loop from the table's values that the
step can reach, so that nothing of size T^2 reaches device memory.  At T =
2,999 it is bound by its operations: 4 B H T^2 D (QK^T and PV) at the bf16
rate; q, k, v, the gates and the table are read once, the f32 output
written once (:func:`rel_attention_flops`, :func:`rel_attention_bytes`).
Key steps that lie wholly beyond the offset where the buckets saturate
(|s - t| >= 778 for 320 buckets and distance 800: about half of them at T =
2,999) add the table's end value instead.  The source's head comment holds
the design.

On CPU tensors it runs :func:`rel_attention_plain`, the written-out bias
in plain torch on the same bf16-rounded operands, in f32.  Each CUDA launch
adds one to ``rel_attention.launches`` and its operations to
``rel_attention.flops``: ``FlopCounterMode`` does not see the kernel.
"""

from __future__ import annotations

import torch

#: the one head size the kernel takes
HEAD_DIM = 64


def rel_attention_flops(b: int, h: int, t: int, d: int) -> int:
    """QK^T and PV: 4 B H T^2 D."""
    return 4 * b * h * t * t * d


def rel_attention_bytes(b: int, h: int, t: int, d: int) -> int:
    """q, k, v in bf16 read once, the f32 output written once, the f32
    gates and the f32 (H, 2T - 1) table read once."""
    return 3 * 2 * b * h * t * d + 4 * b * h * t * d + 4 * b * h * t \
        + 4 * h * (2 * t - 1)


def _check(q, k, v, gates, table) -> tuple[int, int, int, int]:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f'q, k, v must be equal (B, T, H, D); got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    b, t, h, d = q.shape
    if tuple(gates.shape) != (b, t, h):
        raise ValueError(f'gates must be (B, T, H) = {(b, t, h)}; got '
                         f'{tuple(gates.shape)}')
    if tuple(table.shape) != (h, 2 * t - 1):
        raise ValueError(f'table must be (H, 2T - 1) = {(h, 2 * t - 1)}; '
                         f'got {tuple(table.shape)}')
    devices = {x.device for x in (q, k, v, gates, table)}
    if len(devices) != 1:
        raise ValueError(f'all operands on one device; got {devices}')
    return b, t, h, d


def offsets(t: int) -> torch.Tensor:
    """(T, T) index into a (2T - 1) table row: s - t + T - 1."""
    r = torch.arange(t)
    return r[None, :] - r[:, None] + t - 1


def rel_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        gates: torch.Tensor, table: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """The written-out bias: (B, T, H, D) q, k, v (any dtype, taken as
    they are and summed in f32), (B, T, H) gates, (H, 2T - 1) table ->
    (B, T, H, D) f32."""
    b, t, h, d = _check(q, k, v, gates, table)
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    bias = table.float()[:, offsets(t).to(table.device)]        # (H, T, T)
    s = (qf @ kf.transpose(-1, -2)) * scale \
        + gates.float().permute(0, 2, 1)[..., None] * bias[None]
    return (torch.softmax(s, dim=-1) @ vf).permute(0, 2, 1, 3).contiguous()


def flat_distance(row: torch.Tensor) -> int:
    """The least d >= 1 such that every entry of the (2T - 1) table row
    ``row`` (a bucket index or a value per offset) at an offset <= -d
    equals the first and every one at an offset >= d equals the last; T
    when there is none."""
    t = (row.numel() + 1) // 2
    row = row.cpu()
    left = row[:t - 1] != row[0]            # offsets -(T - 1) .. -1
    right = row[t:] != row[-1]              # offsets 1 .. T - 1
    d_left = t - int(left.nonzero().min()) if left.any() else 1
    d_right = int(right.nonzero().max()) + 2 if right.any() else 1
    return min(max(d_left, d_right), t)


def rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  gates: torch.Tensor, table: torch.Tensor,
                  scale: float, flat: int | None = None) -> torch.Tensor:
    """Attention with the gated relative bias: (B, T, H, 64) bf16 q, k, v
    (any strides with the last one 1), (B, T, H) f32 gates, (H, 2T - 1)
    f32 table -> (B, T, H, 64) f32.  CUDA tensors launch K6; CPU tensors
    run :func:`rel_attention_plain`.

    ``flat``: the caller's promise that the table is constant at offsets
    |s - t| >= ``flat`` on each side (:func:`flat_distance` of its bucket
    row; T5's buckets saturate at their maximum distance).  K6 then adds
    the table's end value for the key steps that lie wholly beyond it, and
    reads the table for the others.  None: T, no such steps."""
    b, t, h, d = _check(q, k, v, gates, table)
    if q.device.type != 'cuda':
        return rel_attention_plain(q, k, v, gates, table, scale)
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f'K6 takes bf16 q, k, v; got {q.dtype}, {k.dtype}, '
                         f'{v.dtype}')
    if d != HEAD_DIM:
        raise ValueError(f'K6 takes a head size of {HEAD_DIM}; got {d}')
    q, k, v = (_rows_aligned(x) for x in (q, k, v))
    gates = gates.float()
    table = table.float().contiguous()
    out = torch.empty((b, t, h, d), dtype=torch.float32, device=q.device)
    strides = [s for x in (q, k, v, gates) for s in x.stride()[:3]]
    if max(strides) >= 2 ** 31:
        raise ValueError('K6 takes strides below 2^31 elements')
    from a2m_torch import _build
    lib = _build.load('rel_attention')
    code = lib.a2m_rel_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), gates.data_ptr(),
        table.data_ptr(), out.data_ptr(), *strides, b, t, h,
        t if flat is None else max(1, min(int(flat), t)),
        float(scale) * _LOG2E,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, 'rel_attention')
    rel_attention.launches += 1
    rel_attention.flops += rel_attention_flops(b, h, t, d)
    return out


def _rows_aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where its rows are 16-byte aligned (the kernel copies
    them 16 bytes at a time), else a contiguous aligned copy."""
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in x.stride()[:3])):
        return x
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


#: kernel launches, and their operations, since the counts were last set to 0
rel_attention.launches = 0
rel_attention.flops = 0

_LOG2E = 1.4426950408889634
