"""The port's reference-checkpoint import (a2m_torch/compat) against a2m's
(a2m/compat), on the CPU.

Reference state dicts are made to the reference's key schema by the
shape functions of ``tests/test_compat.py`` at its tiny sizes (``TINY_G``,
``TINY_D``), from seeded numpy.  Both packages start from the same
variables (a2m's init carried into the port), so every leaf of the port's
import, read back in a2m's layout (``to_jax_variables``), must equal a2m's
import bit for bit, with the same ``skipped``, ``unused`` and ``missing``
entries.  The imported generator's eval forward is held to a2m's within
1e-5 of max|ref|.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from a2m.compat import import_discriminator as jax_import_discriminator
from a2m.compat import import_generator as jax_import_generator
from a2m.models import Discriminator as JaxDiscriminator
from a2m.models import Generator as JaxGenerator
from a2m_torch.compat import (ImportReport, import_discriminator,
                              import_generator, load_torch_generator)
from a2m_torch.compat.__main__ import main as compat_main
from a2m_torch.config import (Config, DiscriminatorConfig, GeneratorConfig,
                              apply_overrides)
from a2m_torch.models.discriminator import Discriminator
from a2m_torch.models.generator import Generator
from a2m_torch.weights import (from_jax_variables, load_generator_npz,
                               to_jax_variables)
from test_compat import (TINY_D, TINY_G, _rng_sd,
                         discriminator_state_dict_shapes,
                         generator_state_dict_shapes)
from torch_parity import max_rel

KEY = jax.random.PRNGKey(0)
G_FIELDS = ('in_channels', 'out_channels', 'joint_feat_dim', 'gat_heads',
            'dropout')
D_FIELDS = ('out_channels', 'joint_feat_dim', 'gat_heads', 'dropout')
PORT_G = GeneratorConfig(**{f: getattr(TINY_G, f) for f in G_FIELDS})
OVERRIDES = ([f'generator.{f}={getattr(TINY_G, f)}' for f in G_FIELDS]
             + [f'discriminator.{f}={getattr(TINY_D, f)}' for f in D_FIELDS])
#: the imported generator's eval forward against a2m's, share of max|ref|
FORWARD_TOL = 1e-5


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _flat(variables) -> dict:
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        dict(variables), sep='/').items()}


@pytest.fixture(scope='module')
def gen_pair():
    """a2m's tiny generator and its init, and the port's generator holding
    the same init."""
    model = JaxGenerator(TINY_G)
    variables = jax.jit(model.init)({'params': KEY, 'dropout': KEY},
                                    jnp.zeros((1, 64, 128)))
    port = Generator(PORT_G)
    port.load_state_dict(from_jax_variables(_flat(variables), port))
    return model, variables, port.eval()


def _disc_pair(audio_fusion: bool, aux: bool):
    model = JaxDiscriminator(dataclasses.replace(TINY_D,
                                                 use_aux_classifier=aux))
    extra = (jnp.zeros((1, 4, 256)),) if audio_fusion else ()
    variables = jax.jit(model.init)({'params': KEY, 'dropout': KEY},
                                    jnp.zeros((1, 63, 104)), *extra)
    port = Discriminator(DiscriminatorConfig(
        **{f: getattr(TINY_D, f) for f in D_FIELDS},
        audio_fusion=audio_fusion, use_aux_classifier=aux),
        audio_feats=256)
    port.load_state_dict(from_jax_variables(_flat(variables), port))
    return model, variables, port


def _to_pyg1(sd: dict) -> dict:
    """PyG 1.x GATConv keys: ``weight`` (Ci, H*F) and a fused ``att``
    (1, H, 2F) in (dst || src) order."""
    out = dict(sd)
    for key in [k for k in sd if k.endswith('.att_src')]:
        t = key[:-len('.att_src')]
        out[f'{t}.weight'] = np.ascontiguousarray(out.pop(f'{t}.lin.weight').T)
        out[f'{t}.att'] = np.concatenate(
            [out.pop(f'{t}.att_dst'), out.pop(f'{t}.att_src')], axis=-1)
    return out


def _same_report(got: ImportReport, ref) -> None:
    assert got.unused == sorted(ref.unused)
    assert sorted(got.missing) == sorted(ref.missing)
    assert (sorted((tuple(sorted(k)), r) for k, r in got.skipped)
            == sorted((tuple(sorted(k)), r) for k, r in ref.skipped))


def _assert_bit_equal(model, state: dict, ref_vars) -> None:
    twin = copy.deepcopy(model)
    twin.load_state_dict(state)
    got, want = to_jax_variables(twin), _flat(ref_vars)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('schema', ['plain', 'fixed_up_attention', 'pyg1'])
def test_generator_import_matches_a2m(gen_pair, schema):
    """Every leaf bit-equal to a2m's import, the same report."""
    _, variables, port = gen_pair
    rng = np.random.default_rng(1)
    sd = _rng_sd(rng, generator_state_dict_shapes(
        TINY_G, fixed_up_attention=schema == 'fixed_up_attention'))
    sd['body_edge_index_template'] = np.zeros((2, 18), np.int64)  # buffer
    if schema == 'pyg1':
        sd = _to_pyg1(sd)
    ref_vars, ref_report = jax_import_generator(sd, variables)
    state, report = import_generator(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, port)
    _same_report(report, ref_report)
    assert report.unused == []
    if schema == 'fixed_up_attention':
        assert report.missing == [] and report.skipped == []
    else:
        assert report.missing and all('up_attention' in m[0]
                                      for m in report.missing)
    _assert_bit_equal(port, state, ref_vars)


@pytest.mark.parametrize('branch', ['plain', 'audio_fusion', 'aux'])
def test_discriminator_import_matches_a2m(branch):
    """D, plain (the audio and aux tensors skipped), with audio fusion (the
    checkpoint's logits rows in the leading inputs, the fusion rows at
    init) and with the aux classifier: bit-equal, the same report."""
    _, variables, port = _disc_pair(branch == 'audio_fusion',
                                    branch == 'aux')
    sd = _rng_sd(np.random.default_rng(2),
                 discriminator_state_dict_shapes(TINY_D))
    ref_vars, ref_report = jax_import_discriminator(sd, variables)
    state, report = import_discriminator(sd, port)
    _same_report(report, ref_report)
    assert report.unused == [] and report.missing == []
    reasons = ' '.join(r for _, r in report.skipped)
    assert ('audio fusion' in reasons) == (branch != 'audio_fusion')
    assert ('aux classifier' in reasons) == (branch != 'aux')
    assert ('fusion-input rows' in reasons) == (branch == 'audio_fusion')
    _assert_bit_equal(port, state, ref_vars)


@pytest.mark.parametrize('width', ['tiny', 'full'])
def test_chip_smoke_schema_is_the_tests(width):
    """``chip_smoke.py`` keeps its own copy of the reference schema (it may
    not import these tests, which import jax); the copy gives the same keys
    and shapes as ``tests/test_compat.py``'s builders, at the tiny sizes
    and at the full widths phase 14 migrates."""
    import chip_smoke
    from a2m.config import DiscriminatorConfig as JaxDiscriminatorConfig
    from a2m.config import GeneratorConfig as JaxGeneratorConfig
    if width == 'tiny':
        g, d, jg, jd = PORT_G, DiscriminatorConfig(**{
            f: getattr(TINY_D, f) for f in D_FIELDS}), TINY_G, TINY_D
    else:
        g, d = GeneratorConfig(), DiscriminatorConfig()
        jg, jd = JaxGeneratorConfig(), JaxDiscriminatorConfig()
    assert chip_smoke.reference_generator_keys(g) == \
        generator_state_dict_shapes(jg, fixed_up_attention=True)
    assert chip_smoke.reference_discriminator_keys(d) == \
        discriminator_state_dict_shapes(jd)


def test_import_rejects_unknown_keys_and_shape_mismatch(gen_pair):
    """An unknown key is reported unused and raises on request; a shape
    mismatch raises, naming it (tests/test_compat.py:442-458)."""
    _, _, port = gen_pair
    sd = _rng_sd(np.random.default_rng(3), generator_state_dict_shapes(TINY_G))
    sd['totally_bogus.weight'] = np.zeros((3, 3), np.float32)
    _, report = import_generator(sd, port)
    assert report.unused == ['totally_bogus.weight']
    with pytest.raises(ValueError, match='unconsumed'):
        report.raise_if_unexpected()
    del sd['totally_bogus.weight']
    sd['body_proj_in.weight'] = np.zeros((7, 7), np.float32)
    with pytest.raises(ValueError, match='shape'):
        import_generator(sd, port)


def test_head_permutation_markers(gen_pair):
    """Zero weights + semantic-index head biases: the imported port
    generator emits channel s == s for every block-layout channel
    (tests/test_compat.py:422-440), within 1e-5."""
    _, _, port = gen_pair
    shapes = generator_state_dict_shapes(TINY_G)
    sd = {k: np.zeros(v, np.float32) if v else np.float32(0)
          for k, v in shapes.items()}
    for k in shapes:      # keep BN eval well-defined
        if k.endswith('running_var'):
            sd[k] = np.ones(shapes[k], np.float32)
    sd['body_logits.bias'] = np.arange(0, 20, dtype=np.float32)
    sd['hand_logits.bias'] = np.arange(20, 104, dtype=np.float32)
    state, _ = import_generator(sd, port)
    twin = copy.deepcopy(port)
    twin.load_state_dict(state)
    with torch.no_grad():
        y = twin.eval()(torch.zeros(1, 64, 128)).numpy()
    np.testing.assert_allclose(y[0], np.broadcast_to(
        np.arange(104, dtype=np.float32), (64, 104)), atol=1e-5)


def test_imported_generator_forward_matches_a2m(gen_pair):
    model, variables, port = gen_pair
    rng = np.random.default_rng(4)
    sd = _rng_sd(rng, generator_state_dict_shapes(TINY_G))
    ref_vars, _ = jax_import_generator(sd, variables)
    state, _ = import_generator(sd, port)
    twin = copy.deepcopy(port)
    twin.load_state_dict(state)
    audio = rng.standard_normal((2, 64, 128)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        ref_vars, jnp.asarray(audio)))
    with torch.no_grad():
        got = twin.eval()(torch.from_numpy(audio)).numpy()
    assert max_rel(got, ref) <= FORWARD_TOL, max_rel(got, ref)


@pytest.fixture
def reference_files(tmp_path):
    """Seeded reference G and D ``state_dict`` files, as the reference
    trainer saves them (``torch.save``)."""
    rng = np.random.default_rng(5)
    g_sd = _rng_sd(rng, generator_state_dict_shapes(TINY_G))
    d_sd = _rng_sd(rng, discriminator_state_dict_shapes(TINY_D))
    paths = tmp_path / 'Best_Gen', tmp_path / 'Best_Dis'
    for sd, path in zip((g_sd, d_sd), paths):
        torch.save({k: torch.from_numpy(np.asarray(v))
                    for k, v in sd.items()}, path)
    return g_sd, d_sd, paths


def test_cli_writes_f32_npz_that_loads_bit_equal(reference_files, tmp_path,
                                                 capsys):
    """``python -m a2m_torch.compat``: f32 ``best_gen.npz`` and
    ``imported_disc.npz``, each bit-equal to the import;
    ``load_torch_generator`` gives the same generator."""
    g_sd, d_sd, (gen_path, disc_path) = reference_files
    out = tmp_path / 'migrated'
    compat_main(['--gen', str(gen_path), '--disc', str(disc_path),
                 '--out', str(out), *OVERRIDES])
    printed = capsys.readouterr().out
    assert 'generator: imported with 1 structural skip(s)' in printed
    assert f'wrote {out / "imported_disc.npz"}' in printed
    cfg = apply_overrides(Config(), OVERRIDES)
    for name, model, sd, fn in (
            ('best_gen.npz', Generator(cfg.generator), g_sd,
             import_generator),
            ('imported_disc.npz', Discriminator(cfg.discriminator), d_sd,
             import_discriminator)):
        with np.load(out / name) as z:
            assert all(z[k].dtype == np.float32 for k in z.files), name
        flat, stats = load_generator_npz(out / name)
        assert stats == {}
        state = from_jax_variables(flat, model)
        # the leaves left at init are the migration's seeded ones (seed 0)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            seeded = type(model)(model.config)
        want, _ = fn(g_sd if name == 'best_gen.npz' else d_sd, seeded)
        assert state.keys() == want.keys()
        for k in want:
            assert torch.equal(state[k], want[k]), (name, k)
    loaded, report = load_torch_generator(str(gen_path), cfg.generator)
    assert report.unused == []
    flat, _ = load_generator_npz(out / 'best_gen.npz')
    for k, v in from_jax_variables(flat, loaded).items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_init_from_loads_migrated_generator_and_discriminator(
        reference_files, tmp_path):
    """``train.init_from`` of the CLI's output: G and D bit-equal to the
    files, the log line ``G+D``; a2m's Orbax ``imported_disc/`` raises."""
    from a2m_torch.data.synthetic import synthetic_loader
    from a2m_torch.train.loop import Trainer
    _, _, (gen_path, disc_path) = reference_files
    out = tmp_path / 'migrated'
    compat_main(['--gen', str(gen_path), '--disc', str(disc_path),
                 '--out', str(out), *OVERRIDES])
    loader = synthetic_loader(speakers=('oliver',), intervals_per_speaker=2,
                              duration_s=6.0, batch_size=4, window_hop=30)
    cfg = apply_overrides(Config(), OVERRIDES + [
        f'train.save_dir={tmp_path / "run"}', f'train.init_from={out}',
        'train.log_mfu=false'])
    lines = []
    trainer = Trainer.from_config(cfg, loader, device='cpu', log=lines.append)
    assert f'initialized G+D from {out}' in lines
    for name, model in (('best_gen.npz', trainer.g_state.model),
                        ('imported_disc.npz', trainer.d_state.model)):
        flat, _ = load_generator_npz(out / name)
        want = from_jax_variables(flat, model)
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), (name, k)
    for state in (trainer.g_state, trainer.d_state):
        assert state.optimizer.state_dict()['state'] == {}
    (out / 'imported_disc').mkdir()
    with pytest.raises(ValueError, match='Orbax'):
        Trainer.from_config(cfg, loader, device='cpu', log=lines.append)
