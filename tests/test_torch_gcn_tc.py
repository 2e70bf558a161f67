"""The tensor-core design of the port's dense GCN stack (bf16 mode of
``gcn_kernel.gcn_stack`` and ``gcn_stack_fwd``, ``csrc/gcn_stack.cu``) on
the CPU: its launch plan (``dense_tc_plan``) and a torch mirror of its tile
schedule, held to the plain version and to a2m's dense Pallas kernel
(``fused_gcn_stack(rolled=True, precise=False)``, interpret mode), at the
flagship's widths (F = 64, H = 4).

The mirror packs N graphs into tiles of the plan's T graphs in graph-major
rows, pads them with zero rows to 128 and the features with zeros to 64,
and runs every product over the padded tile with the packed weights (the
layout the kernel reads, ``edge_tc_weights``): X @ W_h, then the apply
sum_h alpha_h @ XW_h and A @ X as products with block-diagonal (128 x 128)
operands that are exact zeros off each graph's (J x J) block and off its
edges; bf16 roundings at each of a2m's ``_kernel``'s points (x, W, XW_h,
alpha, the neighbour sums); a_src, a_dst from x . (W_h att) in float64 and
LayerNorm's sums in float64, as the kernel takes them.  The card's kernel
runs the same schedule (``chip_smoke.py`` phase 3 holds it to the plain
version).  Tolerances:
* against the plain version, the card's rule: max error within 1% of
  max|ref| and the mean error under 0.01 of the plain version's mean
  bf16-vs-f32 gap (``chip_smoke.BF16_MEAN_SHARE``);
* against a2m's dense kernel in bf16 (the same rounding points, other f32
  summation orders): every graph but at most one within 1e-4 of max|ref|,
  that one within 1% (a rounding tie of one operand can flip either way),
  as ``test_torch_gcn_edge_tc.py`` holds the edge form;
* a graph's rows against the same graph in another call, and with junk in
  the pad rows and in graphs past N: bit-equal.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F_
from jax.lax import Precision

from a2m import constants
from a2m.nn import pallas_gcn
from a2m.nn.graph import GCNStack as JaxStack
from a2m_torch.nn import gcn_kernel as gk
from a2m_torch.nn.graph import GCNStack
from torch_parity import port_module, randomize, unflatten

ADJ = {10: constants.adjacency_from_edges(constants.body_edges(), 10),
       42: constants.adjacency_from_edges(constants.hand_edges(), 42)}
SLOTS = {10: 4, 42: 6}              # most edges of A + I into one node
F, HEADS = 64, 4
BF16_MEAN_SHARE = 0.01


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _block_diagonal(block: torch.Tensor, graphs: int,
                    padded: int) -> torch.Tensor:
    """``graphs`` copies of a (J, J) block on the diagonal of a
    (padded, padded) zero matrix: one operand for a tile's graphs."""
    out = torch.zeros((padded, padded), dtype=block.dtype)
    n = block.shape[0] * graphs
    out[:n, :n] = torch.block_diag(*[block] * graphs)
    return out


def dense_tc_mirror(x: torch.Tensor, params: torch.Tensor,
                    adjacency: torch.Tensor, heads: int,
                    num_layers: int = 5, junk: float = 0.0) -> torch.Tensor:
    """The tensor-core kernel's schedule on (N, J, F) f32, tile by tile.
    ``junk`` fills the pad rows of every operand tile (x's and XW_h's): the
    kernel's are zeros, and nothing in them may reach a real row."""
    n, j, f = x.shape
    fp = gk.TC_FEATURES
    routing = gk.edge_routing(adjacency)
    plan = gk.dense_tc_plan(j, f, heads, routing['slots'], num_layers)
    t_, rows, padded = plan['graphs'], plan['rows'], plan['padded_rows']
    # B blocks back in (in, out) layout: unswizzled, transposed
    weights = gk.edge_tc_weights(params, f, heads, num_layers)
    blocks = [gk.swizzle_block(b).float().t() for b in weights['blocks']]
    att = weights['att']                         # (GAT layers, heads, 2, 64)
    layers = gk._unpack(params, f, heads, num_layers)
    a_op = _block_diagonal(_bf16(adjacency.float()), t_, padded)
    mask = _block_diagonal(gk._edge_mask(adjacency), t_, padded)
    live_rows = torch.arange(padded) < rows

    def pad(v):                                 # (f,) -> (64,), zeros
        return F_.pad(v, (0, fp - f))

    def operand(v):                             # bf16, junk in pad rows
        return torch.where(live_rows[:, None], _bf16(v), junk)

    y = torch.empty_like(x)
    for g0 in range(0, n, t_):
        live = min(t_, n - g0)
        xs = torch.zeros(padded, fp)
        xs[:live * j, :f] = x[g0:g0 + live].reshape(-1, f)
        b = 0
        for i, layer in enumerate(layers):
            bias, scale, shift = (pad(v) for v in layer[-3:])
            xo = operand(xs)
            if i % 2 == 0:
                out = torch.zeros(padded, fp)
                for h in range(heads):
                    xw = operand(xo @ blocks[b + h])
                    a_src, a_dst = (xo.double() @ att[i // 2, h].t()
                                    ).float().unbind(-1)
                    e = F_.leaky_relu(a_dst[:, None] + a_src[None, :],
                                      gk.SLOPE)
                    e = torch.where(mask, e, -float('inf'))
                    m = e.amax(1, keepdim=True)
                    ex = torch.where(mask, torch.exp(e - m), 0.0)
                    alpha = _bf16(ex / ex.sum(1, keepdim=True))
                    alpha = torch.where(mask, alpha, 0.0)   # pad rows: 0/0
                    out = out + alpha @ xw
                b += heads
                v = out / heads + bias
            else:
                neigh = operand(a_op @ xo)
                v = (neigh @ blocks[b]) + (xo @ blocks[b + 1]) + bias
                b += 2
            mean = (v[:, :f].double().sum(-1, keepdim=True) / f).float()
            d = (v - mean) * (torch.arange(fp) < f)
            var = ((d.double() ** 2).sum(-1, keepdim=True) / f).float()
            rs = torch.rsqrt(var + gk.LN_EPS)
            xs = F_.leaky_relu(d * rs * scale + shift, gk.SLOPE) + xs
        y[g0:g0 + live] = xs[:live * j, :f].view(live, j, f)
    return y


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    """Two intra-op threads for this file's many small products (see
    ``test_torch_trainer.py::two_threads``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module', params=[10, 42], ids=['body', 'hand'])
def stack(request):
    """(J, seeded x (13, J, F), packed port params, adjacency tensor,
    a2m's dense Pallas kernel in bf16 on x[:4])."""
    j = request.param
    rng = np.random.default_rng(800 + j)
    x = rng.standard_normal((13, j, F)).astype(np.float32)
    jstack = JaxStack(F, ADJ[j], num_layers=5, heads=HEADS,
                      precision=Precision.HIGHEST)
    flat = randomize(jax.jit(jstack.init)(jax.random.PRNGKey(0), x[:1]), rng)
    jparams = pallas_gcn.extract_stack_params(unflatten(flat)['params'])
    pallas = np.asarray(pallas_gcn.fused_gcn_stack(
        x[:4], jparams, ADJ[j], heads=HEADS, precise=False, rolled=True))
    module = port_module(GCNStack(F, ADJ[j], num_layers=5, heads=HEADS,
                                  fused=True), flat)
    return j, x, module.packed_params(), module.adjacency, pallas


@pytest.mark.parametrize('j,f,heads,graphs,smem', [
    (42, 64, 4, 3, 213_312), (10, 64, 4, 12, 205_984),
    (42, 16, 2, 3, 141_632), (10, 16, 2, 12, 134_304)],
    ids=['hand', 'body', 'hand_f16', 'body_f16'])
def test_plan_takes_whole_graphs_in_padded_rows(j, f, heads, graphs, smem):
    """The main-path shapes (F = 64, H = 4) and the tiny test configs: the
    most whole graphs that fit 128 rows, padded to 128 (two M tiles), the
    GAT layers' weights resident and the shared bytes within the H100's
    227 KB."""
    routing = gk.edge_routing(torch.as_tensor(ADJ[j]))
    assert routing['slots'] == SLOTS[j]
    plan = gk.dense_tc_plan(j, f, heads, SLOTS[j])
    assert plan['graphs'] == graphs and plan['rows'] == j * graphs
    assert plan['rows'] <= plan['padded_rows'] == gk.DENSE_TC_ROWS == 128
    assert j * (graphs + 1) > plan['padded_rows']
    assert plan['smem_bytes'] == smem <= gk.TC_SMEM_LIMIT == 232_448
    assert plan['slots'] == SLOTS[j] and plan['threads'] == 256
    # the layers' share: every GAT head's weight block and W_h att (float64),
    # every layer's bias, ln_scale and ln_bias (GraphConv weights stream)
    assert smem - gk._dense_tc_smem_bytes(j, heads, 0, SLOTS[j]) == (
        3 * heads * (gk.TC_BLOCK + 2 * 64 * 8) + 5 * 3 * 64 * 4)


@pytest.mark.parametrize('j,f,heads,layers,slots', [
    (129, 64, 4, 5, 6), (42, 64, 5, 5, 6), (42, 68, 4, 5, 6),
    (42, 18, 4, 5, 6), (42, 64, 4, 9, 6), (42, 64, 4, 5, 9),
    (4, 16, 2, 5, 5)],
    ids=['rows', 'heads', 'wide', 'ragged_f', 'shared_memory', 'slots',
         'slots_past_j'])
def test_plan_raises_where_the_kernel_does_not_fit(j, f, heads, layers,
                                                   slots):
    """More nodes than a tile's 128 rows, more heads than the apply holds,
    F past 64 or not a multiple of 4, weights past the shared memory (nine
    layers), more edges into a node than its 8 slots or than nodes."""
    with pytest.raises(ValueError):
        gk.dense_tc_plan(j, f, heads, slots, layers)


@pytest.mark.parametrize('n', [1, 4, 13])
def test_mirror_matches_plain(stack, n):
    """N below one tile, one past it, several tiles (ragged at J = 42):
    held to the plain version by the card's rule."""
    j, x, params, adj, _ = stack
    xt = torch.from_numpy(x[:n])
    got = dense_tc_mirror(xt, params, adj, HEADS)
    ref = gk.gcn_stack_plain(xt, params, adj, HEADS)
    ref32 = gk.gcn_stack_plain(xt, params, adj, HEADS, precise=True)
    assert torch.isfinite(got).all() and got.shape == xt.shape
    assert (got - ref).abs().max() <= 0.01 * ref.abs().max()
    gap = (ref - ref32).abs().mean()
    assert (got - ref).abs().mean() <= BF16_MEAN_SHARE * gap, (
        (got - ref).abs().mean() / gap)


def test_mirror_matches_pallas_bf16(stack):
    j, x, params, adj, pallas = stack
    xt = torch.from_numpy(x[:4])
    got = dense_tc_mirror(xt, params, adj, HEADS).numpy()
    scale = np.abs(gk.gcn_stack_plain(xt, params, adj, HEADS,
                                      precise=True).numpy()).max()
    per_graph = np.abs(got - pallas).reshape(-1, j * F).max(1)
    assert (per_graph >= 1e-4 * scale).sum() <= 1, per_graph / scale
    assert per_graph.max() < 0.01 * scale


def test_mirror_graph_does_not_depend_on_n(stack):
    """The first graphs of a longer call equal a call on those graphs alone,
    bit for bit, as the card's prefix check holds the kernel (N in {1,
    T - 1, T + 1} against N = 8192): a graph keeps its place in its tile."""
    j, x, params, adj, _ = stack
    xt = torch.from_numpy(x)
    full = dense_tc_mirror(xt, params, adj, HEADS)
    graphs = gk.DENSE_TC_ROWS // j
    for k in sorted({1, graphs - 1, graphs + 1} & set(range(1, 13))):
        assert torch.equal(dense_tc_mirror(xt[:k], params, adj, HEADS),
                           full[:k])


def test_mirror_keeps_pad_rows_out(stack):
    """Junk in the pad rows of every operand tile, and graphs of junk past N
    in a ragged tile, change no real row: the block-diagonal operands are
    exact zeros there."""
    j, x, params, adj, _ = stack
    xt = torch.from_numpy(x[:2])
    clean = dense_tc_mirror(xt, params, adj, HEADS)
    assert torch.equal(dense_tc_mirror(xt, params, adj, HEADS, junk=1e3),
                       clean)
    junk = torch.cat([xt, 1e3 * torch.ones(1, j, F)])
    assert torch.equal(dense_tc_mirror(junk, params, adj, HEADS)[:2], clean)
