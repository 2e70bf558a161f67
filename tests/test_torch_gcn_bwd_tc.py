"""The tensor-core design of the port's GCN-stack backward (bf16 mode of
``gcn_kernel.gcn_stack_bwd``, ``csrc/gcn_stack_bwd.cu``) on the CPU: its
launch plan (``dense_bwd_tc_plan``) and a torch mirror of its tile
schedule, held to the plain version and to a2m's backward Pallas kernel
(``_bwd_call`` with ``rolled=True, precise=False`` under
``fused_gcn_stack_trainable``, interpret mode), at tiny widths (F = 16,
H = 2).

The mirror packs N graphs into tiles of the plan's T graphs in graph-major
rows, pads them with zero rows to 128 and the features with zeros to 64,
and walks each tile's layers L..1 as the kernel does: the recompute (the
forward's products over the padded tile: X @ W_h, the apply and A @ X with
block-diagonal (128 x 128) operands), LayerNorm and its backward with d_h
masked to zero on pad rows and graphs past N, then every backward product
over the padded tile with the packed weights (the layout the kernel reads,
``edge_tc_weights``): d_XW_h = alpha_h^T @ d_outh and A^T @ d_neigh with
block-diagonal operands, the products with W^T, and the weight gradients
X^T @ d_XW_h, neigh^T @ d_h, X^T @ d_h over the tile's rows; d_alpha, the
softmax backward and d_a over the skeleton's edges; d_att_src as W_h^T of
the summed X^T d_a_src.  bf16 roundings at the kernel's points (x, W,
XW_h, alpha, d_h / H, d_XW_h, neigh, d_h, d_neigh); a_src, a_dst from x .
(W_h att) in float64 and LayerNorm's sums in float64, as the kernel takes
them.  The card's kernel runs the same schedule (``chip_smoke.py`` phase 4
holds it to the plain version).  Tolerances:
* against the plain version, the card's rule: max error within 1% of
  max|ref| for dx and for each parameter gradient, and the mean error of
  dx and of dparams under 0.01 of the plain version's mean bf16-vs-f32 gap
  (``chip_smoke.BF16_MEAN_SHARE``);
* against a2m's bf16 backward: 1% of max|ref| per tensor, as
  ``test_torch_gcn_train.py`` holds the plain version;
* a graph's dx against the same graph in another call, and dx and dparams
  with junk in the pad rows and in graphs past N: bit-equal.
Inputs stay away from LeakyReLU's kink (``gcn_kernel.kink_margin``), as
``chip_smoke.py`` keeps them: there two correct backward passes may take
different slopes.
"""

import jax
import jax.numpy as jnp
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
SLOTS = {10: 4, 42: 6}              # most edges of A + I into / out of a node
F, HEADS, LAYERS = 16, 2, 5
BF16_MEAN_SHARE = 0.01
KINK_MARGIN = 2e-5                  # chip_smoke.KINK_MARGIN


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


def _layer_norm_backward(v, g, scale, shift, f, live):
    """The kernel's LayerNorm and its backward over padded rows: (d_h,
    d_y xhat, d_y), d_h and d_y zero on rows that are not live and on
    columns >= f."""
    cols = torch.arange(v.shape[1]) < f
    mean = (v[:, :f].double().sum(-1, keepdim=True) / f).float()
    xh = (v - mean) * cols
    rs = torch.rsqrt((xh.double() ** 2).sum(-1, keepdim=True).div(f).float()
                     + gk.LN_EPS)
    xh = xh * rs
    y = xh * scale + shift
    keep = live[:, None] & cols
    dy = torch.where(keep, g * torch.where(y >= 0, 1.0, gk.SLOPE), 0.0)
    dxh = dy * scale
    m1 = (dxh.double().sum(-1, keepdim=True) / f).float()
    m2 = ((dxh * xh).double().sum(-1, keepdim=True) / f).float()
    d_h = torch.where(keep, rs * ((dxh - m1) - xh * m2), 0.0)
    return d_h, dy * xh, dy


def dense_bwd_tc_mirror(x0: torch.Tensor, xs: torch.Tensor, g: torch.Tensor,
                        params: torch.Tensor, adjacency: torch.Tensor,
                        heads: int, num_layers: int = 5,
                        junk: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core backward's schedule on (N, J, F) f32, tile by tile:
    ``(dx, dparams)``.  ``junk`` fills the pad rows and the graphs past N
    of every layer's input tile and of the cotangent (the kernel's are
    zeros): the masks must keep all of it out of dx and dparams."""
    n, j, f = x0.shape
    fp = gk.TC_FEATURES
    routing = gk.edge_routing(adjacency)
    plan = gk.dense_bwd_tc_plan(j, f, heads, routing['slots'],
                                routing['out_slots'], num_layers)
    t_, rows, padded = plan['graphs'], plan['rows'], plan['padded_rows']
    # B blocks back in (in, out) layout: unswizzled, transposed
    weights = gk.edge_tc_weights(params, f, heads, num_layers)
    blocks = [gk.swizzle_block(b).float().t() for b in weights['blocks']]
    att = weights['att']                         # (GAT layers, heads, 2, 64)
    layers = gk._unpack(params, f, heads, num_layers)
    first = np.cumsum([0] + [heads if i % 2 == 0 else 2
                             for i in range(num_layers)])
    a_op = _block_diagonal(_bf16(adjacency.float()), t_, padded)
    mask = _block_diagonal(gk._edge_mask(adjacency), t_, padded)

    def pad(v):                                 # (f,) -> (64,), zeros
        return F_.pad(v, (0, fp - f))

    grads = [[torch.zeros_like(t) for t in layer] for layer in layers]
    u = torch.zeros((num_layers + 1) // 2, heads, fp, 2)   # X^T d_a sums
    dx = torch.empty_like(x0)
    for g0 in range(0, n, t_):
        live_n = min(t_, n - g0)
        live = torch.arange(padded) < live_n * j

        def tile(v):                            # junk past the live rows
            out = torch.full((padded, fp), junk)
            out[:, f:] = 0.0
            out[:live_n * j, :f] = v[g0:g0 + live_n].reshape(-1, f)
            return out

        gt = tile(g)
        for i in reversed(range(num_layers)):
            layer, b = layers[i], first[i]
            bias, scale, shift = (pad(v) for v in layer[-3:])
            xo = _bf16(tile(x0 if i == 0 else xs[i - 1]))
            if i % 2 == 0:
                xw, alpha, e = [], [], []
                out = torch.zeros(padded, fp)
                for h in range(heads):
                    xw.append(_bf16(xo @ blocks[b + h]))
                    a_src, a_dst = (xo.double() @ att[i // 2, h].t()
                                    ).float().unbind(-1)
                    e.append(a_dst[:, None] + a_src[None, :])
                    el = torch.where(mask, F_.leaky_relu(e[h], gk.SLOPE),
                                     -float('inf'))
                    ex = torch.where(mask, torch.exp(
                        el - el.amax(1, keepdim=True)), 0.0)
                    alpha.append(torch.where(mask, ex / ex.sum(1, keepdim=True),
                                             0.0))    # pad rows: 0/0
                    out = out + _bf16(alpha[h]) @ xw[h]
                v = out / heads + bias
            else:
                neigh = _bf16(a_op @ xo)
                v = (neigh @ blocks[b]) + (xo @ blocks[b + 1]) + bias
            d_h, dyx, dy = _layer_norm_backward(v, gt, scale, shift, f, live)
            grads[i][-3] += d_h.sum(0)[:f]
            grads[i][-2] += dyx.sum(0)[:f]
            grads[i][-1] += dy.sum(0)[:f]
            if i % 2 == 0:
                d_outh = _bf16(d_h / heads)
                for h in range(heads):
                    d_alpha = d_outh @ xw[h].t()
                    s = (alpha[h] * d_alpha).sum(1, keepdim=True)
                    d_e = torch.where(mask, alpha[h] * (d_alpha - s)
                                      * torch.where(e[h] >= 0, 1.0, gk.SLOPE),
                                      0.0)
                    d_a_dst, d_a_src = d_e.sum(1), d_e.sum(0)
                    att_src, att_dst = (pad(layer[k][h]) for k in (1, 2))
                    d_xw = _bf16(_bf16(alpha[h]).t() @ d_outh
                                 + d_a_src[:, None] * att_src
                                 + d_a_dst[:, None] * att_dst)
                    gt = gt + d_xw @ blocks[b + h].t()
                    grads[i][0][:, h * f:(h + 1) * f] += (xo.t() @ d_xw)[
                        :f, :f]
                    u[i // 2, h] += xo.t() @ torch.stack([d_a_src, d_a_dst],
                                                         -1)
            else:
                d_hb = _bf16(d_h)
                d_neigh = _bf16(d_hb @ blocks[b].t())
                gt = gt + a_op.t() @ d_neigh + d_hb @ blocks[b + 1].t()
                grads[i][0] += (neigh.t() @ d_hb)[:f, :f]
                grads[i][1] += (xo.t() @ d_hb)[:f, :f]
        dx[g0:g0 + live_n] = gt[:live_n * j, :f].view(live_n, j, f)
    for i in range(0, num_layers, 2):
        for h in range(heads):
            w_t = blocks[first[i] + h].t()[:f]     # (out, in): W_h^T
            grads[i][1][h] += w_t @ u[i // 2, h, :, 0]
            grads[i][2][h] += w_t @ u[i // 2, h, :, 1]
    return dx, gk.pack_params(grads)


def away_from_kink(x: torch.Tensor, params, adjacency) -> torch.Tensor:
    """``x`` with each graph that brings a LayerNorm output within
    KINK_MARGIN of LeakyReLU's kink (either mode) replaced by one that does
    not, as ``chip_smoke.away_from_kink`` does."""
    ok = torch.ones(x.shape[0], dtype=torch.bool)
    for precise in (True, False):
        ok &= gk.kink_margin(x, params, adjacency, HEADS,
                             precise=precise) > KINK_MARGIN
    good = ok.nonzero()[:, 0]
    assert len(good) > 0
    x = x.clone()
    bad = (~ok).nonzero()[:, 0]
    x[bad] = x[good[torch.arange(len(bad)) % len(good)]]
    return x


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
    """(J, seeded inputs x0, xs, g of 13 graphs away from the kink, packed
    port params, adjacency tensor, a2m's bf16 (dx, per-tensor gradients) of
    the first 4 graphs)."""
    j = request.param
    rng = np.random.default_rng(900 + j)
    x = rng.standard_normal((13, j, F)).astype(np.float32)
    w = rng.standard_normal((13, j, F)).astype(np.float32)
    jstack = JaxStack(F, ADJ[j], num_layers=LAYERS, heads=HEADS,
                      precision=Precision.HIGHEST)
    flat = randomize(jax.jit(jstack.init)(jax.random.PRNGKey(0), x[:1]), rng)
    module = port_module(GCNStack(F, ADJ[j], num_layers=LAYERS, heads=HEADS,
                                  fused=True), flat)
    params, adj = module.packed_params(), module.adjacency
    x0 = away_from_kink(torch.from_numpy(x), params, adj)
    _, xs = gk.gcn_stack_fwd_plain(x0, params, adj, HEADS, LAYERS)
    jparams = pallas_gcn.extract_stack_params(unflatten(flat)['params'])

    def loss(x_, params_):
        y = pallas_gcn.fused_gcn_stack_trainable(
            x_, params_, ADJ[j], heads=HEADS, precise=False, rolled=True)
        return (y * w[:4]).sum()
    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x0[:4].numpy()),
                                            jparams)
    pallas = (np.asarray(gx), [np.asarray(t) for t in gp])
    return j, x0, xs, torch.from_numpy(w), params, adj, pallas


@pytest.mark.parametrize('j,f,heads,graphs,smem', [
    (42, 64, 4, 3, 224_272), (10, 64, 4, 12, 212_304),
    (42, 16, 2, 3, 166_928), (10, 16, 2, 12, 154_960)],
    ids=['hand', 'body', 'hand_f16', 'body_f16'])
def test_bwd_plan_takes_whole_graphs_in_padded_rows(j, f, heads, graphs,
                                                    smem):
    """The main-path shapes (F = 64, H = 4) and the tiny test configs: the
    forward's tile (the most whole graphs that fit 128 rows, padded to
    128), one layer's weights resident and the shared bytes within the
    H100's 227 KB."""
    routing = gk.edge_routing(torch.as_tensor(ADJ[j]))
    assert routing['slots'] == routing['out_slots'] == SLOTS[j]
    plan = gk.dense_bwd_tc_plan(j, f, heads, SLOTS[j], SLOTS[j])
    fwd = gk.dense_tc_plan(j, f, heads, SLOTS[j])
    assert (plan['graphs'], plan['rows'], plan['padded_rows']) == (
        fwd['graphs'], fwd['rows'], fwd['padded_rows'])
    assert plan['graphs'] == graphs and plan['rows'] == j * graphs
    assert plan['smem_bytes'] == smem <= gk.TC_SMEM_LIMIT == 232_448
    assert plan['slots'] == SLOTS[j] and plan['threads'] == 256
    # the layers' share: each GAT head's att vectors (f32) and X^T d_a
    # sums, and every layer's bias, ln_scale and ln_bias (the weights and
    # W_h att stream, one layer at a time)
    assert smem - gk._dense_bwd_tc_smem_bytes(j, heads, 0, SLOTS[j]) == (
        3 * heads * 64 * 2 * (4 + 4) + 5 * 3 * 64 * 4)


@pytest.mark.parametrize('j,f,heads,layers,slots,out_slots', [
    (129, 64, 4, 5, 6, 6), (42, 64, 5, 5, 6, 6), (42, 68, 4, 5, 6, 6),
    (42, 18, 4, 5, 6, 6), (42, 64, 4, 15, 6, 6), (42, 64, 4, 5, 9, 6),
    (42, 64, 4, 5, 6, 9), (4, 16, 2, 5, 5, 4)],
    ids=['rows', 'heads', 'wide', 'ragged_f', 'shared_memory', 'slots',
         'out_slots', 'slots_past_j'])
def test_bwd_plan_raises_where_the_kernel_does_not_fit(j, f, heads, layers,
                                                       slots, out_slots):
    """More nodes than a tile's 128 rows, more heads than 4, F past 64 or
    not a multiple of 4, per-layer vectors past the shared memory (15
    layers), more edges into or out of a node than its 8 slots or than
    nodes."""
    with pytest.raises(ValueError):
        gk.dense_bwd_tc_plan(j, f, heads, slots, out_slots, layers)


@pytest.mark.parametrize('n', [1, 4, 13])
def test_bwd_mirror_matches_plain(stack, n):
    """N below one tile, one past it (J = 42), several tiles: held to the
    plain version by the card's rule."""
    j, x0, xs, g, params, adj, _ = stack
    args = (x0[:n], xs[:, :n], g[:n], params, adj, HEADS)
    dx, dp = dense_bwd_tc_mirror(*args)
    ref, ref32 = (gk.gcn_stack_bwd_plain(*args, precise=p)
                  for p in (False, True))
    assert dx.shape == x0[:n].shape and dp.shape == params.shape
    assert torch.isfinite(dx).all() and torch.isfinite(dp).all()
    assert (dx - ref[0]).abs().max() <= 0.01 * ref[0].abs().max()
    for got, want in zip(gk._unpack(dp, F, HEADS, LAYERS),
                         gk._unpack(ref[1], F, HEADS, LAYERS)):
        for a, b in zip(got, want):
            assert (a - b).abs().max() <= 0.01 * b.abs().max()
    for k in (0, 1):
        err = ((dx, dp)[k] - ref[k]).abs().mean()
        gap = (ref[k] - ref32[k]).abs().mean()
        assert err <= BF16_MEAN_SHARE * gap, (k, err / gap)


def test_bwd_mirror_matches_pallas_bf16(stack):
    """a2m's bf16 backward (rolled heads) on the first 4 graphs, at the
    tolerance ``test_torch_gcn_train.py`` holds the plain version to."""
    j, x0, xs, g, params, adj, (gx, gp) = stack
    dx, dp = dense_bwd_tc_mirror(x0[:4], xs[:, :4], g[:4], params, adj,
                                 HEADS)
    np.testing.assert_allclose(dx.numpy(), gx, atol=0.01 * np.abs(gx).max())
    got = [t.numpy() for layer in gk._unpack(dp, F, HEADS, LAYERS)
           for t in layer]
    assert len(got) == len(gp)
    for i, (a, b) in enumerate(zip(got, gp)):
        np.testing.assert_allclose(a, b.reshape(a.shape),
                                   atol=0.01 * np.abs(b).max(),
                                   err_msg=f'param {i}')


def test_bwd_mirror_dx_does_not_depend_on_n(stack):
    """A graph's dx in a longer call equals a call on the first graphs
    alone, bit for bit, as the card's prefix check holds the kernel (N in
    {1, T - 1, T + 1} against N = 8192): a graph keeps its place in its
    tile and its rows depend on its own graph."""
    j, x0, xs, g, params, adj, _ = stack
    full, _ = dense_bwd_tc_mirror(x0, xs, g, params, adj, HEADS)
    graphs = gk.DENSE_TC_ROWS // j
    for k in sorted({1, graphs - 1, graphs + 1} & set(range(1, 13))):
        dx, _ = dense_bwd_tc_mirror(x0[:k], xs[:, :k], g[:k], params, adj,
                                    HEADS)
        assert torch.equal(dx, full[:k]), k


def test_bwd_mirror_keeps_pad_rows_out(stack):
    """Junk in the pad rows and in the graphs past N of every layer's input
    and of the cotangent changes neither dx nor any parameter gradient: d_h
    is zero there, and so is every operand that meets them."""
    j, x0, xs, g, params, adj, _ = stack
    args = (x0[:2], xs[:, :2], g[:2], params, adj, HEADS)
    clean = dense_bwd_tc_mirror(*args)
    dirty = dense_bwd_tc_mirror(*args, junk=1e3)
    assert torch.equal(dirty[0], clean[0]) and torch.equal(dirty[1], clean[1])


def test_bwd_routing_and_cost():
    """The transposed lists' width: the skeletons are undirected, so as
    many edges leave a node as enter it; and the backward's bound counts
    more operations than twice the forward's."""
    for j, adj in ADJ.items():
        routing = gk.edge_routing(torch.as_tensor(adj))
        assert routing['out_slots'] == routing['slots'] == SLOTS[j]
        assert gk.stack_bwd_flops(8192, adj, 64, 4) > 2 * gk.stack_flops(
            8192, adj, 64, 4)
