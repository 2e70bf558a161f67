"""The port's audio I/O, resamplers, GMM VAD and Audio modality
(a2m_torch/audio/{io,mel_np,vad}.py, a2m_torch/data/modalities.py) against
a2m's.

The resamplers and the VAD are numpy copies: equal to a2m's within 1e-12
and exactly.  Features from a wav file go through the exact-mode frontend
(on the CPU its float64 plain version) and are held to a2m's
``wav_to_features`` (its exact XLA path) within 1e-5, a2m's exact-mode
bound.
"""

import numpy as np
import pytest

from a2m.audio import io as jio
from a2m.audio import mel_np as jmel_np
from a2m.audio import vad as jvad
from a2m.data import make_synthetic_pats
from a2m.data.modalities import Audio as JaxAudio
from a2m_torch.audio import io, mel_np, vad
from a2m_torch.data.modalities import Audio

SR = 45600


@pytest.fixture(scope='module')
def speech_like():
    """1.5 s at 45.6 kHz: bursts of a voiced harmonic stack between
    stretches of quiet noise, so the VAD has both classes."""
    rng = np.random.default_rng(12)
    t = np.arange(int(SR * 1.5)) / SR
    voiced = sum(np.sin(2 * np.pi * f * t) / k
                 for k, f in enumerate((180, 360, 540, 720), 1))
    gate = (np.sin(2 * np.pi * 1.3 * t) > 0).astype(np.float64)
    return 0.3 * voiced * gate + 0.01 * rng.standard_normal(t.size)


@pytest.mark.parametrize('orig,target', [(SR, 16000), (16000, SR),
                                         (44100, 16000), (16000, 16000)])
def test_resamplers_equal_a2m(orig, target):
    y = np.random.default_rng(orig).standard_normal(orig // 4)
    for method in ('kaiser_best', 'polyphase'):
        got = mel_np.resample(y, orig, target, method)
        ref = jmel_np.resample(y, orig, target, method)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-12
    np.testing.assert_array_equal(mel_np._kaiser_best_table(),
                                  jmel_np._kaiser_best_table())
    with pytest.raises(ValueError, match='unknown resample'):
        mel_np.resample(y, orig, target, 'sinc')


@pytest.mark.parametrize('kind', ['f32', 'int16'])
def test_wav_round_trip(tmp_path, kind):
    rng = np.random.default_rng(13)
    y = np.clip(rng.standard_normal(8000) * 0.3, -1, 1)
    if kind == 'int16':
        y = (y * 32767).astype(np.int16)
    io.save_wav(tmp_path / 'a.wav', y, 16000)
    jio.save_wav(tmp_path / 'b.wav', y, 16000)
    assert (tmp_path / 'a.wav').read_bytes() == (tmp_path /
                                                 'b.wav').read_bytes()
    got, sr = io.load_wav(tmp_path / 'a.wav')
    ref, jsr = jio.load_wav(tmp_path / 'a.wav')
    assert sr == jsr == 16000 and got.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    # f32 in [-1, 1] is stored as int16: one quantisation step
    want = y / 32767 if kind == 'int16' else y
    assert np.abs(got - want).max() <= 1.0 / 32767


@pytest.mark.parametrize('method', ['log_mel_512', 'log_mel_400', 'vggish'])
def test_wav_to_features_matches_a2m(tmp_path, method):
    rng = np.random.default_rng(14)
    path = tmp_path / 'clip.wav'
    io.save_wav(path, rng.standard_normal(SR) * 0.1, SR)
    got = io.wav_to_features(path, method, device='cpu')
    ref = jio.wav_to_features(path, method)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-5
    with pytest.raises(ValueError, match='unknown method'):
        io.wav_to_features(path, 'mfcc', device='cpu')


def test_extract_audio_needs_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(io.shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match='ffmpeg'):
        io.extract_audio_from_video(tmp_path / 'v.mp4', tmp_path / 'a.wav')


def test_silence_stream_equals_a2m(speech_like):
    y16 = jmel_np.resample(speech_like, SR, 16000).astype(np.float32)
    got = vad.silence_stream(y16)
    ref = jvad.silence_stream(y16)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    assert 0 < got[0::2].sum() < got[0::2].size      # both classes
    np.testing.assert_array_equal(vad.gmm_frame_decisions(y16),
                                  jvad.gmm_frame_decisions(y16))
    # a constant signal has no bimodal structure
    flat = np.full(16000, 0.2, np.float32)
    np.testing.assert_array_equal(vad.silence_stream(flat),
                                  jvad.silence_stream(flat))


@pytest.fixture(scope='module')
def pats_root(tmp_path_factory):
    return make_synthetic_pats(tmp_path_factory.mktemp('pats_audio'),
                               speakers=('oliver',), intervals_per_speaker=1,
                               duration_s=2.0)


def test_audio_modality_equals_a2m(pats_root, speech_like):
    """``Audio`` on the CPU: the exact log-mels of a harmonic, speech-like
    clip within 1e-5 of the float64 golden on the same f32 samples, and of
    a2m's ``Audio`` within 5e-5, the bound a2m's tonal test holds its own
    exact path to (tests/test_audio_frontend.py:129-140): on this clip
    (mels over 74 dB) a2m's exact path is 4.9e-5 from the golden, the port
    4.7e-7.  The silence stream exactly; ``device='cuda'`` raises without
    CUDA."""
    port = Audio(path2data=pats_root, device='cpu')
    ref = JaxAudio(path2data=pats_root, use_pallas=False)
    y = speech_like[:SR]
    y32 = y.astype(np.float32).astype(np.float64)
    goldens = {'log_mel_512': jmel_np.log_mel_512(y32, SR),
               'log_mel_400': jmel_np.log_mel_400(
                   jmel_np.resample(y, SR, 16000).astype(np.float32)
                   .astype(np.float64), 16000)}
    for name in ('log_mel_512', 'log_mel_400'):
        got, want = getattr(port, name)(y, SR), getattr(ref, name)(y, SR)
        assert got.shape == want.shape == goldens[name].shape
        assert got.dtype == np.float32
        assert np.abs(got - goldens[name]).max() < 1e-5, name
        assert np.abs(got - want).max() < 5e-5, name
    np.testing.assert_array_equal(port.silence(y, SR), ref.silence(y, SR))
    assert port.fs('audio/log_mel_512') == ref.fs('audio/log_mel_512') == 89
    assert port.fs('audio/log_mel_400') == ref.fs('audio/log_mel_400') == 103
    assert port.h5_key == 'audio'
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            Audio(path2data=pats_root)
