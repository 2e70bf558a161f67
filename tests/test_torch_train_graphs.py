"""CUDA graphs of the train steps (``a2m_torch/train/graphs.py``) and what
they need of the steps around them.

On the CPU: when graphs apply (CUDA and no process group), that the CPU
trainer stays eager, one graph per input signature, a graph dropped and
captured again when what it captured is replaced, the metrics copied out of
a replay, the label parameters and inputs fed through static tensors, no
stale pack from ``GCNStack.packed_params`` or ``gcn_kernel.edge_tc_weights``
once a graph owns the parameters, ``set_lr`` and ``place_adam``, and the
losses' index constants built once per device.  The capture there is a
stand-in (:class:`FakeCapture`) that writes as a replay does: in place, no
version bumped.

On the card (skipped without CUDA; run with ``--noconftest``, since the
machine with the card has no JAX): two flagship trainers from one seed, one
graphed and one kept eager, over two epochs of three batches with the
learning rates and label parameters changing at the epoch boundary and one
D step skipped: every step's losses, and the final parameters, BatchNorm
statistics and Adam moments of both nets, bit-equal.
"""

import datetime

import numpy as np
import pytest
import torch
from torch import nn

from a2m_torch import constants
from a2m_torch.models import discriminator as disc_mod
from a2m_torch.models import losses as L
from a2m_torch.nn import gcn_kernel
from a2m_torch.nn.graph import GCNStack
from a2m_torch.nn.layers import adaptive_pool_matrix
from a2m_torch.train import graphs, train_step
from a2m_torch.train.train_step import NetState


class FakeCapture:
    """``graphs.capture`` on the CPU: the capture runs the step once with
    nothing written (a capture executes nothing), a replay runs it again
    and writes its metrics into the captured ones in place; the step
    writes parameters through ``.data``, so no version moves, as a graph's
    kernels write them."""

    def __init__(self):
        self.count = 0
        self.capturing = self.replaying = False

    def __call__(self, fn, pool, generator):
        self.count += 1
        self.capturing = True
        try:
            out = fn()
        finally:
            self.capturing = False

        def replay():
            self.replaying = True
            try:
                for k, v in fn()[2].items():
                    out[2][k].copy_(v)
            finally:
                self.replaying = False
        return replay, out, ('pool', self.count)


def _stub_step(fake, kind='d'):
    """A step of ``kind`` that moves the stepped net's parameters by the
    first label value (unless capturing), launches K1 twice by its counter
    (where its Python runs: eagerly or under capture) and reports a loss of
    its inputs and labels."""
    def step(g_state, d_state, audio, pose, mean, std, *rest, style=None,
             mask=None):
        *labels, key = rest
        stepped = g_state if kind == 'g' else d_state
        if not fake.replaying:
            gcn_kernel.gcn_stack.launches += 2
        if not fake.capturing:
            with torch.no_grad():
                for p in stepped.model.parameters():
                    p.data.add_(labels[0])
        loss = (audio.sum() + pose.sum()) * labels[0] + labels[-1]
        if mask is not None:
            loss = loss + mask.sum()
        out = {'loss': loss.detach()}
        return ((g_state, d_state, out) if kind == 'g'
                else (d_state, g_state, out))
    return step


def _net(model):
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    # never stepped here: the flag alone lets the graphs apply on the CPU
    opt.param_groups[0]['capturable'] = True
    return NetState(model, opt)


@pytest.fixture
def fake(monkeypatch):
    """Graphs applied on the CPU through the stand-in capture."""
    capture = FakeCapture()
    monkeypatch.setattr(graphs, 'capture', capture)
    monkeypatch.setattr(graphs, 'applies', lambda device: True)
    return capture


def _batch(b, mask=True):
    gen = torch.Generator().manual_seed(b)
    return (torch.randn(b, 4, 3, generator=gen),
            torch.randn(b, 4, 2, generator=gen),
            torch.ones(b) if mask else None)


#: the pose statistics and label generator every call passes (a graph
#: holds them: new objects are captured again)
MEAN, STD, KEY = torch.zeros(2), torch.ones(2), torch.Generator()


def _call(step, g, d, batch, smooth=0.5, noise=0.01):
    audio, pose, mask = batch
    return step(g, d, audio, pose, MEAN, STD, smooth, noise, KEY, mask=mask)


@pytest.mark.parametrize('device,group,want', [
    ('cpu', False, False), ('cuda', False, True), ('cuda', True, False),
    ('cpu', True, False)], ids=['cpu', 'cuda', 'cuda_group', 'cpu_group'])
def test_graphs_apply_on_cuda_without_a_process_group(device, group, want):
    import torch.distributed as dist
    if group:
        store = dist.HashStore()
        store.set_timeout(datetime.timedelta(seconds=30))
        dist.init_process_group('gloo', store=store, rank=0, world_size=1)
    try:
        assert graphs.applies(torch.device(device)) is want
    finally:
        if group:
            dist.destroy_process_group()


def test_the_cpu_trainer_stays_eager(monkeypatch):
    """A CPU epoch of the tiny trainer captures nothing (the capture
    raises), and its Adam keeps the CPU's settings."""
    from a2m_torch.config import (DiscriminatorConfig, GeneratorConfig,
                                  TrainConfig)
    from a2m_torch.models.discriminator import Discriminator
    from a2m_torch.models.generator import Generator
    from a2m_torch.train.loop import Trainer

    def refuse(*a, **k):
        raise AssertionError('captured on the CPU')

    monkeypatch.setattr(graphs, 'capture', refuse)
    torch.manual_seed(0)
    g = Generator(GeneratorConfig(in_channels=16, out_channels=16,
                                  joint_feat_dim=8, gat_heads=2))
    d = Discriminator(DiscriminatorConfig(joint_feat_dim=8, gat_heads=2))
    gen = torch.Generator().manual_seed(0)
    batch = (torch.randn(1, 64, 128, generator=gen),
             torch.randn(1, 64, 104, generator=gen) * 10 + 300, None,
             torch.ones(1))
    tr = Trainer(g, d, TrainConfig(log_mfu=False), train_batches=[batch],
                 log=lambda line: None)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        tr.train_epoch(0)
    finally:
        torch.set_num_threads(threads)
    assert tr.g_step.graphs == {} and tr.d_step.graphs == {}
    for state in (tr.g_state, tr.d_state):
        group = state.optimizer.param_groups[0]
        assert group['capturable'] is False
        assert isinstance(group['lr'], float)


def test_one_graph_per_input_signature(fake):
    """Captured on the first call of each signature (a D step), replayed
    after; the returned metrics are copies that the next replay leaves
    alone; inputs and labels reach the replay through static tensors."""
    g, d = _net(nn.Linear(2, 2)), _net(nn.Linear(2, 2))
    step = graphs.GraphedStep(_stub_step(fake), 'd', [])
    first = _call(step, g, d, _batch(2))[2]['loss']
    value = float(first)
    for batch in (_batch(2), _batch(3), _batch(2), _batch(3),
                  _batch(2, mask=False)):
        _call(step, g, d, batch)
    assert fake.count == 3 and len(step.graphs) == 3
    assert float(first) == value
    audio, pose, mask = _batch(3)
    got = _call(step, g, d, (audio, pose, mask), smooth=0.25, noise=0.5)
    want = (audio.sum() + pose.sum()) * 0.25 + 0.5 + mask.sum()
    assert float(got[2]['loss']) == pytest.approx(float(want))
    assert got[0] is d and got[1] is g


def test_a_g_step_runs_eager_once_then_captures(fake):
    g, d = _net(nn.Linear(2, 2)), _net(nn.Linear(2, 2))
    step = graphs.GraphedStep(_stub_step(fake, 'g'), 'g', [])
    w0 = g.model.weight.detach().clone()
    _call(step, g, d, _batch(2))
    assert fake.count == 0
    for _ in range(3):
        _call(step, g, d, _batch(2))
    assert fake.count == 1
    # four steps of +0.5 each: the capture wrote nothing, its replay did
    assert torch.equal(g.model.weight.detach(), w0 + 2.0)


@pytest.mark.parametrize('kind', ['g', 'd'])
def test_a_replay_counts_the_kernels_it_launches(fake, monkeypatch, kind):
    """The launch counters count every step's launches, a replay's too,
    once: the capture's own replay is counted by the capture."""
    monkeypatch.setattr(gcn_kernel.gcn_stack, 'launches', 0)
    g, d = _net(nn.Linear(2, 2)), _net(nn.Linear(2, 2))
    step = graphs.GraphedStep(_stub_step(fake, kind), kind, [])
    for calls in range(1, 5):
        _call(step, g, d, _batch(2))
        assert gcn_kernel.gcn_stack.launches == 2 * calls
    assert fake.count == 1


def test_an_operation_counter_sees_an_eager_step(fake):
    """Under ``FlopCounterMode`` a step that has a graph runs eagerly (a
    replay would dispatch nothing to count); a capture may run under one."""
    from torch.utils.flop_counter import FlopCounterMode
    g, d = _net(nn.Linear(2, 2)), _net(nn.Linear(2, 2))
    step = graphs.GraphedStep(_stub_step(fake), 'd', [])
    replays = []
    with FlopCounterMode(display=False):
        _call(step, g, d, _batch(2))            # captured
    rec = next(iter(step.graphs.values()))
    replay = rec.replay
    rec.replay = lambda: replays.append(1) or replay()
    with FlopCounterMode(display=False):
        _call(step, g, d, _batch(2))
    assert fake.count == 1 and replays == []
    _call(step, g, d, _batch(2))
    assert replays == [1]


@pytest.mark.parametrize('replaced,captures', [
    ('nothing', 1), ('module_state', 1), ('optimizer_state', 2),
    ('parameter_storage', 2), ('optimizer', 2), ('pose_statistics', 2)])
def test_a_graph_is_captured_again_when_its_state_is_replaced(
        fake, replaced, captures):
    """A restore of the optimiser (a new state dict), a parameter's new
    storage, a new optimiser or new pose statistics drop the graph; a
    module's ``load_state_dict`` copies in place and keeps it."""
    g, d = _net(nn.Linear(2, 2)), _net(nn.Linear(2, 2))
    step = graphs.GraphedStep(_stub_step(fake), 'd', [])
    _call(step, g, d, _batch(2))
    if replaced == 'module_state':
        d.model.load_state_dict({k: v.clone() for k, v in
                                 d.model.state_dict().items()})
    elif replaced == 'optimizer_state':
        d.optimizer.load_state_dict(d.optimizer.state_dict())
    elif replaced == 'parameter_storage':
        d.model.bias.data = d.model.bias.data.clone()
    elif replaced == 'optimizer':
        d = _net(d.model)
    audio, pose, mask = _batch(2)
    mean = MEAN.clone() if replaced == 'pose_statistics' else MEAN
    step(g, d, audio, pose, mean, STD, 0.5, 0.01, KEY, mask=mask)
    assert fake.count == captures and len(step.graphs) == 1


def test_a_d_capture_finds_adams_state_made_beforehand(fake):
    """A D step captures on its first call: Adam's state (step 0, zero
    moments) exists before the capture, for every trainable parameter."""
    g, d = _net(nn.Linear(2, 2)), _net(nn.Linear(2, 3))
    d.model.bias.requires_grad_(False)
    step = graphs.GraphedStep(_stub_step(fake), 'd', [])
    _call(step, g, d, _batch(2))
    state = d.optimizer.state
    assert list(state) == [d.model.weight]
    entry = state[d.model.weight]
    assert list(entry) == ['step', 'exp_avg', 'exp_avg_sq']
    assert float(entry['step']) == 0.0
    assert not entry['exp_avg'].any() and not entry['exp_avg_sq'].any()


def test_a_replay_leaves_no_stale_pack(fake):
    """Once a graph owns a GCN stack's parameters, eager code after a
    replay (an eval step, an eager D step, a later capture) packs the
    parameters the replay wrote: ``packed_params`` and ``edge_tc_weights``
    key their caches on the version, which a replay alone does not move."""
    torch.manual_seed(0)
    f, heads, layers = 8, 2, 5
    adjacency = constants.adjacency_from_edges(constants.body_edges(),
                                               constants.NUM_BODY_JOINTS)
    stack = GCNStack(f, adjacency, num_layers=layers, heads=heads,
                     fused=True)
    g, d = _net(nn.Linear(2, 2)), _net(stack)

    def weights():
        return gcn_kernel.edge_tc_weights(stack.packed_params(), f, heads,
                                          layers)

    def fresh():
        return gcn_kernel.edge_tc_weights(stack._pack(), f, heads, layers)

    cached = weights()
    # the hazard: an in-place write that moves no version leaves both
    # caches stale
    with torch.no_grad():
        for p in stack.parameters():
            p.data.add_(0.125)
    assert torch.equal(weights()['blocks'], cached['blocks'])
    assert not torch.equal(fresh()['blocks'], cached['blocks'])
    step = graphs.GraphedStep(_stub_step(fake), 'd', [])
    for _ in range(2):
        _call(step, g, d, _batch(2))
        want = fresh()
        got = weights()
        assert torch.equal(stack.packed_params(), stack._pack())
        assert torch.equal(got['blocks'], want['blocks'])
        assert torch.equal(got['att'], want['att'])


@pytest.mark.parametrize('lr', ['float', 'tensor'])
def test_set_lr(lr):
    """A float learning rate is replaced, a tensor one filled in place
    (the tensor a graph of the step reads)."""
    p = nn.Parameter(torch.zeros(3))
    start = 1e-3 if lr == 'float' else torch.tensor(1e-3)
    opt = torch.optim.Adam([p], lr=start)
    train_step.set_lr(opt, 2.5e-4)
    got = opt.param_groups[0]['lr']
    if lr == 'float':
        assert got == 2.5e-4
    else:
        assert got is start and float(got) == pytest.approx(2.5e-4)


def test_place_adam_restores_the_cpus_settings():
    """A state dict written on the card (capturable, a tensor learning
    rate, step counts on the device) loads into a CPU Adam with the CPU's
    settings, which its step accepts."""
    p = nn.Parameter(torch.ones(3))
    opt = train_step.make_optimizer([p], 1e-3)
    p.grad = torch.ones(3)
    opt.step()
    saved = opt.state_dict()
    saved['param_groups'][0].update(capturable=True, lr=torch.tensor(1e-3))
    opt.load_state_dict(saved)
    train_step.place_adam(opt)
    group = opt.param_groups[0]
    assert group['capturable'] is False and group['lr'] == pytest.approx(1e-3)
    assert isinstance(group['lr'], float)
    assert opt.state[p]['step'].device.type == 'cpu'
    opt.step()
    assert float(opt.state[p]['step']) == 2.0


def test_loss_indices_are_built_once_per_device(monkeypatch):
    """``losses._index`` keeps one tensor per values and device, and the
    losses read from it equal those of a fresh index tensor a call."""
    gen = torch.Generator().manual_seed(3)
    pose = torch.randn(2, 8, 104, generator=gen) * 10
    joints = L.to_joints(pose)
    hand = constants.hand_triples()
    bones, angles = L.bone_lengths(pose), L._signed_angles(joints, hand)
    built = dict(L._indices)
    L.bone_lengths(pose), L._signed_angles(joints, hand)
    assert L._indices.keys() == built.keys()
    assert all(L._indices[k] is v for k, v in built.items())
    assert (L._index(constants.JOINT_SUBSET, 'cpu')
            is L._index(constants.JOINT_SUBSET, torch.device('cpu')))
    monkeypatch.setattr(L, '_index', lambda values, device: torch.as_tensor(
        np.asarray(values), dtype=torch.long, device=device))
    assert torch.equal(L.bone_lengths(pose), bones)
    assert torch.equal(L._signed_angles(joints, hand), angles)


def test_the_discriminators_pool_matrix_is_built_once():
    like = torch.zeros(2, dtype=torch.float64)
    w = disc_mod._pool_matrix(64, 13, like)
    assert disc_mod._pool_matrix(64, 13, like) is w
    assert w.dtype == torch.float64
    assert torch.equal(w, adaptive_pool_matrix(64, 13).double())


# -- on the card --------------------------------------------------------------

B, EPOCHS, BATCHES = 16, 2, 3


class _Recorded:
    """A trainer's step with every call's metrics kept on the host."""

    def __init__(self, step, kind, log):
        self.step, self.kind, self.log = step, kind, log

    def __call__(self, *args, **kwargs):
        out = self.step(*args, **kwargs)
        self.log.append((self.kind, {k: float(v) for k, v in out[2].items()}))
        return out


def _card_run(graphed: bool) -> tuple:
    """A flagship trainer (``build_trainer``, seed 7) over two epochs of
    three seeded batches of B = 16 on the card: the learning rates change
    at the epoch boundary (the label parameters anneal by epoch), and the
    controller skips the first epoch's second D step."""
    from a2m_torch import pipeline
    tr = pipeline.build_trainer(batch=B, seed=7, log=lambda line: None)
    gen = torch.Generator().manual_seed(11)
    tr.train_batches = [
        (torch.randn(B, 64, 128, generator=gen).cuda(),
         (torch.randn(B, 64, 104, generator=gen) * 20 + 300).cuda(), None,
         torch.ones(B, device='cuda')) for _ in range(BATCHES)]
    tr.g_step.eager = tr.d_step.eager = not graphed
    graphed_steps = (tr.g_step, tr.d_step)
    log: list = []
    tr.g_step = _Recorded(tr.g_step, 'g', log)
    tr.d_step = _Recorded(tr.d_step, 'd', log)
    ctrl = tr.controller
    lrs = [(5e-4, 1e-3), (4e-4, 1.2e-3)]
    ctrl.adjust_learning_rates = lambda epoch: lrs[epoch]
    trains_d = iter([True, False] + [True] * (EPOCHS * BATCHES - 2))
    ctrl.should_train_discriminator = lambda: next(trains_d)
    torch.manual_seed(5)
    for epoch in range(EPOCHS):
        tr.train_epoch(epoch)
    torch.cuda.synchronize()
    nets = {}
    for name, state in (('g', tr.g_state), ('d', tr.d_state)):
        nets[name] = {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()}
        for i, p in enumerate(state.model.parameters()):
            for k, v in state.optimizer.state[p].items():
                nets[name][f'adam.{i}.{k}'] = v.clone()
    return log, nets, graphed_steps


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the graphs are captured there')


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms for the test: without them two
    eager runs of one seed already part in the last bits on the card (the
    convolutions' weight gradients), and graphs could not be told from
    that."""
    from a2m_torch.parallel import mesh
    mesh.set_deterministic(True)
    try:
        yield
    finally:
        mesh.set_deterministic(False)


@pytest.mark.chip
def test_graphed_training_is_bit_equal_to_eager_on_the_card(card,
                                                            deterministic):
    log_e, nets_e, steps_e = _card_run(graphed=False)
    log_g, nets_g, steps_g = _card_run(graphed=True)
    assert all(not s.graphs for s in steps_e)
    # one graph a kind: G captured at its second call, D at its first
    assert [len(s.graphs) for s in steps_g] == [1, 1]
    kinds = [k for k, _ in log_g]
    assert kinds == [k for k, _ in log_e]
    assert kinds.count('d') == EPOCHS * BATCHES - 1
    assert log_g == log_e
    for net in ('g', 'd'):
        assert nets_g[net].keys() == nets_e[net].keys()
        unequal = [k for k in nets_e[net]
                   if not torch.equal(nets_g[net][k], nets_e[net][k])]
        assert not unequal, f'{net}: {unequal[:8]}'
