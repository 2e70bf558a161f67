"""The tensor-core design of the port's edge-form GCN stack (bf16 mode of
``gcn_kernel.gcn_stack_edge``, ``csrc/gcn_stack_edge.cu``) on the CPU: its
launch plan (``edge_tc_plan``), its bf16 weight pack (``edge_tc_weights``)
and a torch mirror of its tile schedule, held to the plain version and to
a2m's edge-form Pallas kernel (``fused_gcn_stack(edge_form=True, tile=8)``,
interpret mode).

The mirror packs N graphs into tiles of the plan's T graphs in joint-major
rows, pads them with zero rows to the plan's multiple of 64 and the
features with zeros to 64, runs every product over the padded tile with
the packed weights, and unpacks; the card's kernel runs the same schedule
(``chip_smoke.py`` phase 8 holds it to the plain version).  Tolerances:
* against the plain version, the card's rule: max error within 1% of
  max|ref| and the mean error under 0.01 of the plain version's mean
  bf16-vs-f32 gap (``chip_smoke.BF16_MEAN_SHARE``);
* against a2m's edge kernel in bf16, the rule of
  ``test_torch_gcn_edge.py::test_edge_plain_bf16_matches_pallas_edge_bf16``:
  every graph but at most one within 1e-4 of max|ref|, that one within 1%;
* a graph's rows against the same graph in another tile: bit-equal.
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
EDGES = {10: (28, 18), 42: (122, 80)}           # (E, Ec) of each skeleton
F, HEADS = 16, 2
BF16_MEAN_SHARE = 0.01


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def tc_mirror(x: torch.Tensor, params: torch.Tensor,
              adjacency: torch.Tensor, heads: int,
              num_layers: int = 5) -> torch.Tensor:
    """The tensor-core kernel's schedule on (N, J, F) f32, tile by tile."""
    n, j, f = x.shape
    fp = gk.TC_FEATURES
    routing = gk.edge_routing(adjacency)
    e, ec = routing['edges'], routing['conv_edges']
    plan = gk.edge_tc_plan(j, f, heads, e, ec, num_layers)
    t_, rows, padded, chunk = (plan['graphs'], plan['rows'],
                               plan['padded_rows'], plan['head_chunk'])
    route = routing['route'].long()
    src, dst = route[:e], route[e:2 * e]
    csrc = route[2 * e + j + 1:2 * e + j + 1 + ec]
    cdst = torch.repeat_interleave(
        torch.arange(j), torch.diff(route[2 * e + j + 1 + ec:]))
    cw = _bf16(routing['conv_w'])
    # B blocks back in (in, out) layout: unswizzled, transposed
    weights = gk.edge_tc_weights(params, f, heads, num_layers)
    blocks = [gk.swizzle_block(b).float().t() for b in weights['blocks']]
    att = weights['att']                         # (GAT layers, heads, 2, 64)
    layers = gk._unpack(params, f, heads, num_layers)
    tt = torch.arange(t_)

    def pad(v):                                 # (f,) -> (64,), zeros
        return F_.pad(v, (0, fp - f))

    def rows_of(nodes):                         # (K,) nodes -> (K, T) rows
        return nodes[:, None] * t_ + tt[None, :]

    y = torch.empty_like(x)
    for g0 in range(0, n, t_):
        live = min(t_, n - g0)
        xt = torch.zeros(t_, j, fp)
        xt[:live, :, :f] = x[g0:g0 + live]
        xs = xt.transpose(0, 1).reshape(rows, fp)          # joint-major
        xo = torch.zeros(padded, fp)
        xo[:rows] = _bf16(xs)
        b = 0
        for i, layer in enumerate(layers):
            bias, scale, shift = (pad(v) for v in layer[-3:])
            if i % 2 == 0:
                out = torch.zeros(rows, fp)
                for h in range(heads):                     # chunk order
                    xw = xo @ blocks[b + h]                # (padded, 64)
                    a_src, a_dst = (xo[:rows].double() @ att[i // 2, h].t()
                                    ).float().unbind(-1)
                    rs, rd = rows_of(src), rows_of(dst)     # (E, T)
                    logit = F_.leaky_relu(a_src[rs] + a_dst[rd], gk.SLOPE)
                    m = torch.full((rows,), -float('inf')).scatter_reduce(
                        0, rd.reshape(-1), logit.reshape(-1), 'amax')
                    ex = torch.exp(logit - m[rd])
                    den = torch.zeros(rows).index_add(0, rd.reshape(-1),
                                                      ex.reshape(-1))
                    alpha = ex / den[rd]
                    z = _bf16(_bf16(xw)[rs] * alpha[..., None])
                    out = out + torch.zeros(rows, fp).index_add(
                        0, rd.reshape(-1), z.reshape(-1, fp))
                b += heads
                v = out / heads + bias
            else:
                rs, rd = rows_of(csrc), rows_of(cdst)
                neigh = torch.zeros(padded, fp)
                neigh[:rows] = _bf16(torch.zeros(rows, fp).index_add(
                    0, rd.reshape(-1),
                    (cw[:, None, None] * _bf16(xs)[rs]).reshape(-1, fp)))
                v = ((neigh @ blocks[b]) + (xo @ blocks[b + 1]))[:rows] \
                    + bias
                b += 2
            mean = v[:, :f].sum(-1, keepdim=True) / f
            d = (v - mean) * (torch.arange(fp) < f)
            rs_ = torch.rsqrt((d * d).sum(-1, keepdim=True) / f + gk.LN_EPS)
            xs = F_.leaky_relu(d * rs_ * scale + shift, gk.SLOPE) + xs
            xo[:rows] = _bf16(xs)
        y[g0:g0 + live] = xs.view(j, t_, fp).transpose(0, 1)[:live, :, :f]
    return y


@pytest.fixture(scope='module', params=[10, 42], ids=['body', 'hand'])
def stack(request):
    """(J, seeded x (7, J, F), packed port params, adjacency tensor,
    a2m's edge-form Pallas kernel in bf16 on x, a2m's kernel-order
    parameters)."""
    j = request.param
    rng = np.random.default_rng(700 + j)
    x = rng.standard_normal((7, j, F)).astype(np.float32)
    jstack = JaxStack(F, ADJ[j], num_layers=5, heads=HEADS,
                      precision=Precision.HIGHEST)
    flat = randomize(jax.jit(jstack.init)(jax.random.PRNGKey(0), x), rng)
    jparams = pallas_gcn.extract_stack_params(unflatten(flat)['params'])
    pallas = np.asarray(pallas_gcn.fused_gcn_stack(
        x, jparams, ADJ[j], heads=HEADS, precise=False, edge_form=True,
        tile=8))
    module = port_module(GCNStack(F, ADJ[j], num_layers=5, heads=HEADS,
                                  fused=True, fused_edge=True), flat)
    return j, x, module.packed_params(), module.adjacency, pallas


def _params(f: int, heads: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(gk.num_params(f, heads, 5), generator=gen)


@pytest.mark.parametrize('f', [16, 64])
@pytest.mark.parametrize('heads', [1, 2, 4])
def test_weight_pack_unpacks_to_rounded_weights(f, heads):
    """Unswizzled and cut to F x F, each block is W[:, h]^T, W_rel^T or
    W_root^T rounded to bf16, bit for bit; the padding is zeros."""
    params = _params(f, heads, seed=f + heads)
    weights = gk.edge_tc_weights(params, f, heads)
    packed, att = weights['blocks'], weights['att']
    assert packed.dtype == torch.bfloat16 and att.dtype == torch.float64
    assert packed.shape == (3 * heads + 2 * 2, 64, 64)
    assert att.shape == (3, heads, 2, 64)
    assert gk.edge_tc_weights(params, f, heads) is weights      # cached
    b = 0
    for i, layer in enumerate(gk._unpack(params, f, heads, 5)):
        mats = ([layer[0][:, h * f:(h + 1) * f] for h in range(heads)]
                if i % 2 == 0 else layer[:2])
        for h, w in enumerate(mats):
            block = gk.swizzle_block(packed[b])
            assert torch.equal(block[:f, :f].float(),
                               gk._op(w, False).t())
            assert not block[f:].any() and not block[:, f:].any()
            b += 1
            if i % 2 == 0:
                # W_h att in float64 from the rounded W_h, zero-padded
                rounded = gk._op(w, False).double()
                for which in (0, 1):
                    torch.testing.assert_close(
                        att[i // 2, h, which, :f],
                        rounded @ layer[1 + which][h].double(), rtol=0,
                        atol=1e-12)
                assert not att[i // 2, h, :, f:].any()
    assert b == len(packed)


def test_weight_pack_swizzle_moves_chunks():
    """Row n's chunk c of 8 values lies at chunk c ^ (n % 8), and the
    swizzle is its own inverse."""
    block = torch.arange(64 * 64, dtype=torch.float32).view(64, 64)
    sw = gk.swizzle_block(block)
    for n in (0, 1, 7, 8, 13, 63):
        for c in range(8):
            assert torch.equal(sw[n, 8 * (c ^ n % 8):8 * (c ^ n % 8) + 8],
                               block[n, 8 * c:8 * c + 8])
    assert torch.equal(gk.swizzle_block(sw), block)


def test_weight_pack_follows_a_new_version():
    params = _params(16, 2, seed=3)
    before = gk.edge_tc_weights(params, 16, 2)['blocks'].clone()
    with torch.no_grad():
        params.mul_(2.0)
    after = gk.edge_tc_weights(params, 16, 2)['blocks']
    assert not torch.equal(before, after)
    assert torch.equal(gk.swizzle_block(after[0])[:16, :16].float(),
                       gk._op(params[:16 * 32].view(16, 32)[:, :16],
                              False).t())


@pytest.mark.parametrize('j,f,heads,graphs,chunk,smem', [
    (42, 64, 4, 3, 4, 231_432), (10, 64, 4, 12, 4, 227_528),
    (42, 16, 2, 3, 2, 144_568), (10, 16, 2, 12, 2, 141_000),
    (42, 8, 2, 3, 2, 144_568), (10, 8, 2, 12, 2, 141_000)],
    ids=['hand', 'body', 'hand_f16', 'body_f16', 'hand_tiny_gen',
         'body_tiny_gen'])
def test_plan_takes_whole_graphs_in_padded_rows(j, f, heads, graphs, chunk,
                                                smem):
    """The serving shapes (F = 64, H = 4) and the tiny test configs: whole
    graphs a tile, rows padded to a multiple of 64 (at most 128), the
    shared bytes within the H100's 227 KB, every head in one chunk."""
    e, ec = EDGES[j]
    plan = gk.edge_tc_plan(j, f, heads, e, ec)
    assert plan['graphs'] == graphs and plan['rows'] == j * graphs
    assert plan['padded_rows'] % 64 == 0
    assert plan['rows'] <= plan['padded_rows'] < plan['rows'] + 64
    assert plan['padded_rows'] <= gk.TC_MAX_ROWS
    assert plan['smem_bytes'] == smem <= gk.TC_SMEM_LIMIT == 232_448
    assert plan['head_chunk'] == chunk and plan['threads'] == 256
    # one more graph would not fit: 128 rows or the shared memory
    more = gk._tc_smem_bytes(j, heads, 5, e, ec, graphs + 1,
                             -(-j * (graphs + 1) // 64) * 64, 1)
    assert j * (graphs + 1) > gk.TC_MAX_ROWS or more > gk.TC_SMEM_LIMIT


@pytest.mark.parametrize('j,f,heads', [(129, 64, 4), (42, 64, 8),
                                       (42, 68, 4), (42, 18, 2)],
                         ids=['rows', 'weights', 'wide', 'ragged_f'])
def test_plan_raises_where_no_tile_fits(j, f, heads):
    with pytest.raises(ValueError):
        gk.edge_tc_plan(j, f, heads, 3 * j, 2 * j)


@pytest.mark.parametrize('heads,chunk,graphs', [(1, 1, 3), (3, 1, 3),
                                                (6, 2, 2)])
def test_plan_chunks_divide_the_heads(heads, chunk, graphs):
    """The most heads a chunk that divides H and fits (six heads' weights
    leave room for two graphs of 42 joints)."""
    plan = gk.edge_tc_plan(42, 16, heads, 122, 80)
    assert plan['head_chunk'] == chunk and plan['graphs'] == graphs
    assert plan['smem_bytes'] <= gk.TC_SMEM_LIMIT


@pytest.mark.parametrize('n', [1, 2, 7, 13])
def test_mirror_matches_plain(stack, n):
    """N < T, N not a multiple of T, N past one tile: held to the plain
    version by the card's rule."""
    j, x, params, adj, _ = stack
    xt = torch.from_numpy(np.resize(x, (n, j, F)))
    got = tc_mirror(xt, params, adj, HEADS)
    ref = gk.gcn_stack_edge_plain(xt, params, adj, HEADS)
    ref32 = gk.gcn_stack_edge_plain(xt, params, adj, HEADS, precise=True)
    assert torch.isfinite(got).all() and got.shape == xt.shape
    scale = ref.abs().max()
    assert (got - ref).abs().max() <= 0.01 * scale
    gap = (ref - ref32).abs().mean()
    assert (got - ref).abs().mean() <= BF16_MEAN_SHARE * gap, (
        (got - ref).abs().mean() / gap)


def test_mirror_matches_pallas_edge_bf16(stack):
    j, x, params, adj, pallas = stack
    got = tc_mirror(torch.from_numpy(x), params, adj, HEADS).numpy()
    ref32 = gk.gcn_stack_edge_plain(torch.from_numpy(x), params, adj, HEADS,
                                    precise=True).numpy()
    scale = np.abs(ref32).max()
    per_graph = np.abs(got - pallas).reshape(-1, j * F).max(1)
    assert (per_graph >= 1e-4 * scale).sum() <= 1, per_graph / scale
    assert per_graph.max() < 0.01 * scale


def test_mirror_graph_does_not_depend_on_its_tile(stack):
    """The first graphs of a longer call equal a call on those graphs alone,
    bit for bit, as the card's prefix check holds the kernel."""
    j, x, params, adj, _ = stack
    xt = torch.from_numpy(x)
    full = tc_mirror(xt, params, adj, HEADS)
    for k in (1, 4):
        assert torch.equal(tc_mirror(xt[:k], params, adj, HEADS), full[:k])


def test_mirror_keeps_pad_rows_out(stack):
    """Pad rows and graphs past N change nothing: garbage in a tile's empty
    graph slots is never read by a live row (every edge is inside a
    graph)."""
    j, x, params, adj, _ = stack
    routing = gk.edge_routing(adj)
    e, ec = routing['edges'], routing['conv_edges']
    route = routing['route']
    for nodes in (route[:e], route[e:2 * e], route[2 * e + j + 1:
                                                  2 * e + j + 1 + ec]):
        assert int(nodes.min()) >= 0 and int(nodes.max()) < j
    xt = torch.from_numpy(x[:2])
    junk = torch.cat([xt, 1e3 * torch.ones(1, j, F)])
    assert torch.equal(tc_mirror(junk, params, adj, HEADS)[:2],
                       tc_mirror(xt, params, adj, HEADS))
