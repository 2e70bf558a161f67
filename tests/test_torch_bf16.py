"""bf16 training (``train.compute_dtype='bf16'``) against a2m's
``Generator(dtype=jnp.bfloat16)`` / ``Discriminator(dtype=jnp.bfloat16)``
at the tiny configuration.

* Dtype flow: the dtype of every port module's output equals that of the
  a2m scope of the same name (``capture_intermediates``), for G and D in
  bf16: a promotion taken wrongly (the GAT bias, ``SelfAttention``'s f32
  gate, the LayerNorms) fails here whatever the tolerances.
* Values, by a2m's own bf16 gap (``torch_parity.assert_within_bf16_gap``):
  for each module and for the models, the port's bf16 result lies within
  2x of |a2m bf16 - a2m f32| from a2m's f32 result and from a2m's bf16
  result, for the max and for the mean of |diff|.  One bf16 ``g_step`` +
  ``d_step`` is held the same way in test_torch_train_step.py, beside the
  f32 steps whose compiled a2m references it shares.
* The flagship: ``a2m_torch/testdata/bf16_golden.json`` holds a2m's
  bf16-vs-f32 gap of the committed flagship at full width on seeded
  features (B = 128; the ``slow`` test regenerates it with a2m and holds
  it to the file), the yardstick of ``chip_smoke.py`` phase 15's bf16
  forward on the card; here the port's CPU forward of its first rows
  keeps within 2x of it.
* What stays f32 under bf16: parameters, gradients, Adam moments,
  BatchNorm statistics, metrics, checkpoints and the best-G ``.npz``; a
  bf16 trainer resumes bit-equal.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from a2m import constants
from a2m.config import DiscriminatorConfig as JaxDConfig
from a2m.config import GeneratorConfig as JaxGConfig
from a2m.models import Discriminator as JaxD
from a2m.models import Generator as JaxG
from a2m.models import losses as JL
from a2m.nn import graph as jgraph
from a2m.nn import layers as jlayers
from a2m_torch import config as tconfig
from a2m_torch.config import DiscriminatorConfig, GeneratorConfig
from a2m_torch.models import losses as L
from a2m_torch.models.discriminator import Discriminator
from a2m_torch.models.generator import Generator
from a2m_torch.nn import graph, layers
from a2m_torch.weights import to_jax_variables
from torch_parity import (assert_within_bf16_gap, port_module, randomize,
                          unflatten)

TINY_G = dict(in_channels=16, out_channels=16, joint_feat_dim=8, gat_heads=2,
              dropout=0.0)
TINY_D = dict(out_channels=8, joint_feat_dim=8, gat_heads=2, dropout=0.0)
BF16 = torch.bfloat16
ADJ10 = constants.adjacency_from_edges(constants.body_edges(), 10)
ROOT = Path(__file__).resolve().parents[1]
BF16_GOLDEN = ROOT / 'a2m_torch' / 'testdata' / 'bf16_golden.json'
FLAGSHIP = ROOT / 'artifacts' / 'flagship_best_gen.npz'
#: rows of the golden's input whose gap the golden also keeps (the CPU
#: test's full-width forward)
GOLDEN_ROWS = 2


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


# ---------------------------------------------------------------------------
# the tiny models: a2m initialised once in f32, applied in f32 and bf16
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def models():
    """Randomised flat variables of the tiny G and D, seeded inputs, and
    a2m's f32 and bf16 outputs (the bf16 ones with their intermediates).
    The variable trees come from the port's modules through
    ``to_jax_variables`` (a2m's own, held by test_torch_weights.py), which
    spares a2m's init, the costliest compile here."""
    rng = np.random.default_rng(7)
    audio = rng.standard_normal((2, 64, 128)).astype(np.float32)
    motion = rng.standard_normal((2, 63, 104)).astype(np.float32)
    out = dict(audio=audio, motion=motion)
    for name, cls, cfg, x in (('g', JaxG, JaxGConfig(**TINY_G), audio),
                              ('d', JaxD, JaxDConfig(**TINY_D), motion)):
        flat = randomize(unflatten(to_jax_variables(_model(name))), rng)
        variables = unflatten(flat)
        m32, m16 = cls(cfg), cls(cfg, dtype=jnp.bfloat16)
        ref32 = jax.jit(m32.apply)(variables, x)
        ref16, inter = jax.jit(lambda v, a: m16.apply(
            v, a, capture_intermediates=True))(variables, x)
        first = (lambda r: r[0]) if name == 'd' else (lambda r: r)
        out[name] = dict(flat=flat, ref32=_np(first(ref32)),
                         ref16=_np(first(ref16)), out16=first(ref16),
                         inter=traverse_util.flatten_dict(
                             inter['intermediates'], sep='/'))
    return out


def _model(name: str, dtype=torch.float32):
    return (Generator(GeneratorConfig(**TINY_G), dtype=dtype) if name == 'g'
            else Discriminator(DiscriminatorConfig(**TINY_D), dtype=dtype))


def _port(name: str, flat: dict, dtype):
    return port_module(_model(name, dtype), flat)


def _forward(model, x):
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize('name', ['g', 'd'])
def test_dtype_flow_matches_a2m_scope_by_scope(models, name):
    """Every port module's output dtype, in call order, against the a2m
    scope of the same name; a2m scopes without a port module (flax's
    ``Dropout_0``, ``Sequential_0``) are skipped."""
    world = models[name]
    model = _port(name, world['flat'], BF16)
    seen: dict[str, list] = {}
    hooks = [module.register_forward_hook(
        lambda m, i, o, n=n: seen.setdefault(n, []).append(
            str(o.dtype).replace('torch.', '')) if torch.is_tensor(o)
        else None) for n, module in model.named_modules()]
    _forward(model, models['audio' if name == 'g' else 'motion'])
    for h in hooks:
        h.remove()
    compared = 0
    for key, values in world['inter'].items():
        scope = key.rpartition('/')[0].replace('/', '.')
        if scope not in seen:
            continue
        want = [str(v.dtype) for v in values]
        assert seen[scope] == want, (key, seen[scope], want)
        compared += 1
    # the port's ChannelAttention calls its MLP layers twice, as a2m
    assert compared >= (150 if name == 'g' else 30), compared
    assert {'float32', 'bfloat16'} <= {d for v in seen.values() for d in v}
    assert str(world['out16'].dtype) == 'float32'


@pytest.mark.parametrize('name', ['g', 'd'])
def test_model_forward_within_a2ms_bf16_gap(models, name):
    world = models[name]
    x = models['audio' if name == 'g' else 'motion']
    got = _forward(_port(name, world['flat'], BF16), x)
    assert got.dtype == torch.float32
    assert_within_bf16_gap(got.numpy(), world['ref32'], world['ref16'], name)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

MODULES = {
    # name: (a2m module of dtype, port module of dtype, input shape)
    'conv_norm_relu_1d': (
        lambda dt: jlayers.ConvNormRelu(8, 12, leaky=True, dtype=dt),
        lambda dt: layers.ConvNormRelu(8, 12, leaky=True, dtype=dt),
        (2, 16, 8)),
    'conv_norm_relu_2d_down': (
        lambda dt: jlayers.ConvNormRelu(3, 8, type='2d', downsample=True,
                                        dtype=dt),
        lambda dt: layers.ConvNormRelu(3, 8, type='2d', downsample=True,
                                       dtype=dt),
        (2, 8, 16, 3)),
    'self_attention': (
        lambda dt: jlayers.SelfAttention(16, dtype=dt),
        lambda dt: layers.SelfAttention(16, dtype=dt), (2, 12, 16)),
    'channel_attention': (
        lambda dt: jlayers.ChannelAttention(16, dtype=dt),
        lambda dt: layers.ChannelAttention(16, dtype=dt), (2, 12, 16)),
    'res_block': (
        lambda dt: jlayers.ResBlock(16, dtype=dt),
        lambda dt: layers.ResBlock(16, dtype=dt), (2, 12, 16)),
    'conv_transpose_1d': (
        lambda dt: jlayers.ConvTranspose1D(16, 8, dtype=dt),
        lambda dt: layers.ConvTranspose1D(16, 8, dtype=dt), (2, 12, 16)),
    'dense_gat': (
        lambda dt: jgraph.DenseGATConv(8, ADJ10, heads=2, dtype=dt),
        lambda dt: graph.DenseGATConv(8, ADJ10, heads=2, dtype=dt),
        (2, 3, 10, 8)),
    'dense_graph_conv': (
        lambda dt: jgraph.DenseGraphConv(8, ADJ10, dtype=dt),
        lambda dt: graph.DenseGraphConv(8, ADJ10, dtype=dt), (2, 3, 10, 8)),
    'gcn_stack': (
        lambda dt: jgraph.GCNStack(8, ADJ10, heads=2, dropout=0.0, dtype=dt),
        lambda dt: graph.GCNStack(8, ADJ10, heads=2, dtype=dt),
        (2, 3, 10, 8)),
    # the fused route: a2m's Pallas kernel (interpret mode) in the bf16
    # model against the eager f32 stack; the port's through the kernels'
    # plain versions (the CPU's)
    'gcn_stack_fused': (
        lambda dt: jgraph.GCNStack(8, ADJ10, heads=2, dropout=0.0, dtype=dt,
                                   fused=dt == jnp.bfloat16,
                                   fused_rolled=True),
        lambda dt: graph.GCNStack(8, ADJ10, heads=2, dtype=dt, fused=True),
        (2, 3, 10, 8)),
}


@pytest.mark.parametrize('name', list(MODULES))
def test_module_within_a2ms_bf16_gap(name):
    make_jax, make_port, shape = MODULES[name]
    rng = np.random.default_rng(list(MODULES).index(name))
    x = rng.standard_normal(shape).astype(np.float32)
    flat = randomize(make_jax(jnp.float32).init(jax.random.PRNGKey(0), x),
                     rng)
    variables = unflatten(flat)
    ref32 = make_jax(jnp.float32).apply(variables, x)
    ref16 = make_jax(jnp.bfloat16).apply(variables, x)
    got = _forward(port_module(make_port(BF16), flat), x)
    bf16_out = ref16.dtype == jnp.bfloat16
    assert got.dtype == (BF16 if bf16_out else torch.float32), (
        got.dtype, ref16.dtype)
    assert_within_bf16_gap(got.float().numpy(), _np(ref32), _np(ref16), name,
                           bf16_out=bf16_out)


def test_losses_on_a_bf16_pose_with_still_frames():
    """Frames repeated in a bf16 pose give exact-zero differences:
    ``safe_norm``'s guard keeps every loss and its gradient finite, and
    the values are a2m's on the same bf16 pose."""
    rng = np.random.default_rng(3)
    pose = rng.standard_normal((2, 8, 104)).astype(np.float32)
    pose[:, 4:] = pose[:, 3:4]
    pose = np.asarray(jnp.asarray(pose, jnp.bfloat16), np.float32)
    real = rng.standard_normal((2, 8, 104)).astype(np.float32)
    t = torch.from_numpy(pose).to(BF16).requires_grad_()
    motion = L.pos_to_motion(t)
    got = [L.temporal_smoothness_loss(motion), L.jerk_loss(motion),
           L.bone_length_loss(torch.from_numpy(real).to(BF16), t),
           L.comprehensive_angle_loss(t)]
    sum(got).backward()
    assert torch.isfinite(t.grad.float()).all()
    def a2m_losses(jp, jr):
        jm = JL.pos_to_motion(jp)
        return [JL.temporal_smoothness_loss(jm), JL.jerk_loss(jm),
                JL.bone_length_loss(jr, jp), JL.comprehensive_angle_loss(jp)]

    ref = jax.jit(a2m_losses)(jnp.asarray(pose, jnp.bfloat16),
                              jnp.asarray(real, jnp.bfloat16))
    for g, r in zip(got, ref):
        assert g.dtype == BF16 and r.dtype == jnp.bfloat16
        np.testing.assert_allclose(float(g.detach()), float(r), rtol=2 ** -7)


# ---------------------------------------------------------------------------
# config, trainer, checkpoints
# ---------------------------------------------------------------------------

def test_validate_accepts_bf16_and_refuses_fp16():
    cfg = tconfig.apply_overrides(tconfig.Config(),
                                  ['train.compute_dtype=bf16'])
    assert tconfig.validate(cfg) is cfg
    assert tconfig.torch_dtype('bf16') == BF16
    assert tconfig.torch_dtype('f32') == torch.float32
    with pytest.raises(ValueError, match='compute_dtype'):
        tconfig.validate(tconfig.apply_overrides(
            tconfig.Config(), ['train.compute_dtype=fp16']))


def test_bf16_trainer_fits_writes_f32_checkpoints_and_resumes(tmp_path):
    """A tiny bf16 ``Trainer.from_config`` (the route of ``python -m
    a2m_torch.train``) fits one epoch on the in-memory synthetic fixture:
    finite losses, an f32 checkpoint (parameters, BatchNorm statistics,
    Adam moments), the best-G ``.npz`` a2m's packing of the f32 state; a
    second trainer on the directory resumes bit-equal."""
    from a2m_torch.data.synthetic import synthetic_loader
    from a2m_torch.train import checkpoint as ckpt_lib
    from a2m_torch.train.loop import Trainer
    loader = synthetic_loader(speakers=('oliver',), intervals_per_speaker=4,
                              duration_s=8.0, seed=0, batch_size=8,
                              max_batches={'train': 1, 'dev': 1})
    cfg = tconfig.apply_overrides(tconfig.Config(), [
        *(f'generator.{k}={v}' for k, v in TINY_G.items()),
        *(f'discriminator.{k}={v}' for k, v in TINY_D.items()),
        f'train.save_dir={tmp_path}', 'train.n_epochs=1',
        'train.log_mfu=false', 'train.compute_dtype=bf16'])
    trainer = Trainer.from_config(cfg, loader, device='cpu', log=lambda s: 0)
    assert trainer.g_state.model.dtype == trainer.d_state.model.dtype == BF16
    trainer.fit()
    history = trainer.loss_history
    assert history['val_g'] and all(np.isfinite(v) for vs in history.values()
                                    for v in vs)
    saved = ckpt_lib.CheckpointManager(tmp_path / 'ckpt').restore()
    for prefix in 'gd':
        for k, v in saved[f'{prefix}_model'].items():
            assert v.dtype == torch.float32, (prefix, k)
        for moments in saved[f'{prefix}_optimizer']['state'].values():
            for k, v in moments.items():
                assert k == 'step' or v.dtype == torch.float32, (prefix, k)
    # the best G is the packing of the f32 state, as an f32 run's
    twin = ckpt_lib.save_best_generator_npz(
        trainer.g_state.model, tmp_path / 'twin.npz', trainer.mean,
        trainer.std)
    with np.load(tmp_path / 'ckpt' / 'best_gen.npz') as z, \
            np.load(twin) as t:
        assert z.files == t.files
        for k in z.files:
            assert z[k].dtype == t[k].dtype and np.array_equal(z[k], t[k]), k
    resumed = Trainer.from_config(cfg, loader, device='cpu', log=lambda s: 0)
    assert resumed.start_epoch == 1
    for a, b in ((trainer.g_state, resumed.g_state),
                 (trainer.d_state, resumed.d_state)):
        for k, v in a.model.state_dict().items():
            assert torch.equal(v, b.model.state_dict()[k]), k
        got = b.optimizer.state_dict()['state']
        for i, moments in a.optimizer.state_dict()['state'].items():
            for k, v in moments.items():
                assert torch.equal(got[i][k], v), (i, k)


# ---------------------------------------------------------------------------
# the flagship's bf16 gap: the golden of chip_smoke.py phase 15
# ---------------------------------------------------------------------------

def golden_features(seed: int, shape) -> np.ndarray:
    """The golden's input: seeded normal log-mel features."""
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _gap(a: np.ndarray, b: np.ndarray) -> dict:
    """|a - b| over (B, T, F): its max, its mean and the median over the
    rows of each row's max (``row_max_median``)."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return dict(max=float(d.max()), mean=float(d.mean()),
                row_max_median=float(np.median(d.max(axis=(1, 2)))))


def make_bf16_golden(seed: int = 0, batch: int = 128) -> dict:
    """a2m's flagship in eval mode (``Generator(fused_gcn=False)``, JAX on
    the CPU) in f32 and in bf16 on ``golden_features(seed, (batch, 64,
    128))``: the gap between the two poses over all rows and over the
    first GOLDEN_ROWS, and max|pose| in f32.

    The batch's max is not a stable yardstick: the flagship's unscaled
    bottleneck attention runs saturated, and where two keys nearly tie a
    bf16 rounding moves one sample's attended frame (the port's bf16
    forward on the CPU does so for row 32 of this input, which doubles its
    max against a2m's: 0.0738 against 0.0369, its mean 1.03x).  So the
    golden keeps the median over the rows of each row's max beside the
    max."""
    from a2m.train.checkpoint import load_best_generator_npz
    best = load_best_generator_npz(FLAGSHIP)
    variables = {'params': best['params'],
                 'batch_stats': best['batch_stats']}
    x = golden_features(seed, (batch, 64, 128))
    poses = {}
    for name, dt in (('f32', jnp.float32), ('bf16', jnp.bfloat16)):
        model = JaxG(JaxGConfig(fused_gcn=False), dtype=dt)
        poses[name] = np.asarray(jax.jit(
            lambda v, a, m=model: m.apply(v, a, train=False))(variables, x))
    assert poses['bf16'].dtype == np.float32
    return dict(
        recipe=dict(npz='artifacts/flagship_best_gen.npz', seed=seed,
                    shape=[batch, 64, 128], model='GeneratorConfig()',
                    input='default_rng(seed).standard_normal(shape), f32',
                    rows=GOLDEN_ROWS),
        gap=_gap(poses['bf16'], poses['f32']),
        gap_rows=_gap(poses['bf16'][:GOLDEN_ROWS],
                      poses['f32'][:GOLDEN_ROWS]),
        max_abs_pose=float(np.abs(poses['f32']).max()),
        out_dtype=str(poses['bf16'].dtype))


@pytest.fixture(scope='module')
def bf16_golden():
    return json.loads(BF16_GOLDEN.read_text())


@pytest.mark.slow
def test_bf16_golden_matches_a2m(bf16_golden):
    fresh = make_bf16_golden(bf16_golden['recipe']['seed'],
                             bf16_golden['recipe']['shape'][0])
    assert fresh['recipe'] == bf16_golden['recipe']
    assert fresh['out_dtype'] == bf16_golden['out_dtype']
    # XLA's CPU code may round differently on another host ISA
    for key in ('gap', 'gap_rows'):
        for stat in fresh[key]:
            np.testing.assert_allclose(fresh[key][stat],
                                       bf16_golden[key][stat], rtol=0.1)
    np.testing.assert_allclose(fresh['max_abs_pose'],
                               bf16_golden['max_abs_pose'], rtol=1e-5)


def test_flagship_bf16_forward_within_the_goldens_gap(bf16_golden):
    """The port's flagship on the CPU, bf16 against f32 (eager stacks), on
    the golden's first rows: within 2x of a2m's gap on those rows, the
    pose f32 as a2m's, max|pose| in f32 as the golden's."""
    from a2m_torch.weights import from_jax_variables, load_generator_npz
    recipe = bf16_golden['recipe']
    x = torch.from_numpy(golden_features(recipe['seed'], recipe['shape'])[
        :recipe['rows']])
    flat, _ = load_generator_npz(FLAGSHIP)
    poses = {}
    for dtype in (torch.float32, BF16):
        model = Generator(GeneratorConfig(), dtype=dtype)
        model.load_state_dict(from_jax_variables(flat, model))
        poses[dtype] = _forward(model.eval(), x.numpy()).numpy()
    assert str(poses[BF16].dtype) == bf16_golden['out_dtype']
    assert np.abs(poses[torch.float32]).max() <= bf16_golden['max_abs_pose']
    gap = _gap(poses[BF16], poses[torch.float32])
    for stat in ('max', 'mean'):
        assert gap[stat] <= 2 * bf16_golden['gap_rows'][stat], (
            stat, gap, bf16_golden['gap_rows'])


if __name__ == '__main__':
    # regenerate the golden: PYTHONPATH=.:tests python tests/test_torch_bf16.py
    BF16_GOLDEN.write_text(json.dumps(make_bf16_golden(), indent=1) + '\n')
