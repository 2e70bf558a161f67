"""Port log-mel (a2m_torch/audio/frontend.py, mel_kernel.py plain version)
on the pose-rate strided spec against a2m's fast mode, a2m's Pallas log-mel
kernel (interpret mode on the CPU) and the float64 numpy golden.

Tolerances: the port's direct windowed DFT and a2m's radix DFT compute the
same f32 function in another order; on a seeded noise clip every mel bin
is far above the f32 noise floor, so the logs agree to 1e-4 (a relative
mel error of 1e-4).  Against the float64 golden, a2m's own fast-mode bound
(tests/test_audio_frontend.py::test_fast_mode_close) of 5e-3 applies.
"""

import numpy as np
import pytest
import torch

from a2m.audio import frontend as jfe
from a2m.audio import mel_np as jmel_np
from a2m.audio.pallas_mel import pallas_log_mel
from a2m_torch.audio import frontend, mel_kernel

SR, STRIDE = 45600, 6


@pytest.fixture(scope='module')
def clip():
    return (np.random.default_rng(0).standard_normal(SR) * 0.1).astype(
        np.float32)


@pytest.fixture(scope='module')
def port_mel(clip):
    spec6 = frontend.strided_spec(frontend.spec_log_mel_512(SR), STRIDE)
    return frontend.log_mel(torch.from_numpy(clip[None]), spec6).numpy()


def _jax_spec6():
    return jfe.strided_spec(jfe.spec_log_mel_512(SR), STRIDE)


def test_matches_a2m_fast_mode(clip, port_mel):
    ref = np.asarray(jfe.log_mel(clip[None], _jax_spec6(), exact=False))
    assert port_mel.shape == ref.shape == (1, 15, 128)
    assert np.abs(port_mel - ref).max() < 1e-4


def test_matches_a2m_pallas_kernel(clip, port_mel):
    ref = np.asarray(pallas_log_mel(clip[None], _jax_spec6()))
    assert port_mel.shape == ref.shape
    assert np.abs(port_mel - ref).max() < 1e-4


def test_matches_float64_golden(clip, port_mel):
    golden = jmel_np.log_mel_512(clip.astype(np.float64), SR)[::STRIDE]
    assert np.abs(port_mel[0] - golden).max() < 5e-3


def test_port_constants_match_a2m():
    spec = frontend.spec_log_mel_512(SR)
    ref = jfe.dft_matrices(jfe.spec_log_mel_512(SR))
    got = frontend.dft_matrices(spec)
    for port_key, ref_key in (('dr', 'drh'), ('di', 'dih'), ('mel', 'melh')):
        np.testing.assert_array_equal(got[port_key], ref[ref_key])


def test_int16_pcm_and_batch_shape(clip):
    spec6 = frontend.strided_spec(frontend.spec_log_mel_512(SR), STRIDE)
    pcm = (clip * 32767).astype(np.int16)
    got = frontend.log_mel(torch.from_numpy(np.stack([pcm, pcm])[None]),
                           spec6, n_frames=8)
    ref = np.asarray(jfe.log_mel(pcm[None], _jax_spec6(), exact=False,
                                 n_frames=8))
    assert got.shape == (1, 2, 8, 128)
    assert np.abs(got[0, 1].numpy() - ref[0]).max() < 1e-4


def test_frames_zero_tail_and_reflect():
    """Frames past the padded end read zero; the pad reflects."""
    y = torch.arange(1.0, 9.0)[None]                  # 8 samples
    frames = mel_kernel.frames_of(y, frame_len=4, hop=4, pad=2, n_frames=4)
    np.testing.assert_array_equal(frames[0].numpy(), [
        [3, 2, 1, 2], [3, 4, 5, 6], [7, 8, 7, 6], [0, 0, 0, 0]])
