"""Tiny-config port Generator against a2m's Generator.apply(train=False)
at Precision.HIGHEST, with seeded random params and batch stats, for both
``fused_gcn`` settings, and the tiny audio->pose slice from the waveform.

Tolerances: the eager port and the fused kernel's f32 (precise) plain
version match a2m to 1e-4 of max|ref| (f32 summation order through ~40
layers).  The fused kernel's default bf16 operands stay within 1% of
max|ref|, the bound tests/test_pallas_gcn.py holds a2m's own fused path to.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.lax import Precision

from a2m.audio import frontend as jfe
from a2m.config import GeneratorConfig as JaxConfig
from a2m.models import Generator as JaxGenerator
from a2m_torch.config import GeneratorConfig
from a2m_torch.models.generator import Generator
from a2m_torch.pipeline import audio_to_pose_fn, pose_rate_spec
from torch_parity import max_rel, port_module, randomize, unflatten

TINY = dict(in_channels=16, out_channels=16, joint_feat_dim=8, gat_heads=2)
SR = 45600


@pytest.fixture(scope='module')
def tiny():
    """(seeded waveform (2, 4.3 s), flat random variables, a2m pose)."""
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal((2, int(SR * 4.3))) * 0.1).astype(np.float32)
    model = JaxGenerator(JaxConfig(**TINY), precision=Precision.HIGHEST)
    spec6 = jfe.strided_spec(jfe.spec_log_mel_512(SR), 6)
    feats = np.array(jfe.log_mel(wave, spec6, exact=False, n_frames=64))
    key = jax.random.PRNGKey(0)
    v = jax.jit(model.init)({'params': key, 'dropout': key}, feats)
    flat = randomize(v, rng)
    ref = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        unflatten(flat), feats))
    return wave, feats, flat, ref


@pytest.mark.parametrize('fused,precise,tol', [
    (False, False, 1e-4), (True, True, 1e-4), (True, False, 1e-2)],
    ids=['eager', 'fused_precise', 'fused_bf16'])
def test_generator_matches_a2m(tiny, fused, precise, tol):
    _, feats, flat, ref = tiny
    cfg = GeneratorConfig(**TINY, fused_gcn=fused, fused_precise=precise)
    port = port_module(Generator(cfg), flat)
    with torch.no_grad():
        got = port(torch.from_numpy(feats)).numpy()
    assert got.shape == ref.shape == (2, 64, 104)
    assert max_rel(got, ref) < tol, max_rel(got, ref)


def test_tiny_slice_waveform_to_pose(tiny):
    """Waveform -> port log-mel -> port generator, as the pipeline runs it,
    against a2m's fast-mode log-mel -> a2m generator."""
    wave, _, flat, ref = tiny
    cfg = dataclasses.replace(GeneratorConfig(**TINY), fused_gcn=True,
                              fused_precise=True)
    audio_to_pose = audio_to_pose_fn(port_module(Generator(cfg), flat), 'cpu')
    got = audio_to_pose(wave).numpy()
    assert pose_rate_spec().hop_length == 3072
    assert max_rel(got, ref) < 1e-4, max_rel(got, ref)
