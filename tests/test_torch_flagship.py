"""The committed flagship generator in the port against a2m's JAX forward.

``a2m_torch/testdata/flagship_golden.npz`` holds a2m's output on a seeded
waveform, so the tier-1 test below checks the full-width port without
compiling the full JAX model: the input is
``default_rng(0).standard_normal((2, 196080)) * 0.1`` (f32), the log-mel is
``frontend.log_mel(spec6, exact=False, n_frames=64)`` and the pose is the
flagship through ``Generator(fused_gcn=False)`` on the CPU in f32.  The
``slow`` test regenerates the golden with JAX and holds it to the file.

Tolerances (port on the CPU, f32): the log-mel within 1e-4 (direct vs
radix DFT, see tests/test_torch_frontend.py; measured 5e-6); the pose
within 1e-5 of max|pose| for the eager and the f32 fused stacks (measured
7e-7: f32 summation order only), and within 1% of max|pose| with the fused
stack's bf16 operands (measured 1.1e-3).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from a2m_torch.config import GeneratorConfig
from a2m_torch.pipeline import (CLIP_SECONDS, SR, audio_to_pose_fn,
                                load_generator, pose_rate_spec)
from a2m_torch.audio import frontend

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / 'a2m_torch' / 'testdata' / 'flagship_golden.npz'
NPZ = ROOT / 'artifacts' / 'flagship_best_gen.npz'


def golden_waveform(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, int(SR * CLIP_SECONDS))) * 0.1).astype(
        np.float32)


def make_golden(seed: int = 0) -> dict:
    """a2m's log-mel and flagship pose on the seeded waveform (JAX, CPU)."""
    import jax
    from a2m.audio import frontend as jfe
    from a2m.config import GeneratorConfig as JaxConfig
    from a2m.models import Generator as JaxGenerator
    from a2m.train.checkpoint import load_best_generator_npz

    wave = golden_waveform(seed)
    spec6 = jfe.strided_spec(jfe.spec_log_mel_512(SR), 6)
    mel = np.asarray(jfe.log_mel(wave, spec6, exact=False, n_frames=64))
    best = load_best_generator_npz(NPZ)
    variables = {'params': best['params'],
                 'batch_stats': best['batch_stats']}
    model = JaxGenerator(JaxConfig(fused_gcn=False))
    pose = np.asarray(jax.jit(lambda v, a: model.apply(v, a, train=False))(
        variables, mel))
    return dict(seed=np.int64(seed), log_mel=mel, pose=pose)


@pytest.fixture(scope='module')
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.slow
def test_golden_file_matches_jax(golden):
    fresh = make_golden(int(golden['seed']))
    # XLA's CPU code may round differently on another host ISA
    np.testing.assert_allclose(fresh['log_mel'], golden['log_mel'], atol=1e-5)
    np.testing.assert_allclose(fresh['pose'], golden['pose'],
                               atol=1e-5 * np.abs(golden['pose']).max())


@pytest.fixture(scope='module')
def port_mel(golden):
    wave = torch.from_numpy(golden_waveform(int(golden['seed'])))
    return frontend.log_mel(wave, pose_rate_spec(), n_frames=64)


def test_port_log_mel_matches_golden(golden, port_mel):
    assert port_mel.shape == golden['log_mel'].shape
    assert np.abs(port_mel.numpy() - golden['log_mel']).max() < 1e-4


@pytest.mark.parametrize('fused,precise,tol', [
    (False, False, 1e-5), (True, True, 1e-5), (True, False, 1e-2)],
    ids=['eager', 'fused_precise', 'fused_bf16'])
def test_port_flagship_matches_golden(golden, port_mel, fused, precise, tol):
    model = load_generator(config=GeneratorConfig(
        fused_gcn=fused, fused_precise=precise), device='cpu')
    with torch.inference_mode():
        pose = model(port_mel).numpy()
    ref = golden['pose']
    assert pose.shape == ref.shape == (2, 64, 104)
    err = np.abs(pose - ref).max() / np.abs(ref).max()
    assert err < tol, err


def test_port_pipeline_runs_waveform_to_pose(golden):
    model = load_generator(config=GeneratorConfig(fused_gcn=True,
                                                  fused_precise=True),
                           device='cpu')
    pose = audio_to_pose_fn(model, 'cpu')(
        golden_waveform(int(golden['seed']))).numpy()
    ref = golden['pose']
    assert np.abs(pose - ref).max() / np.abs(ref).max() < 1e-5


if __name__ == '__main__':
    # regenerate the golden: python tests/test_torch_flagship.py
    np.savez(GOLDEN, **make_golden())
