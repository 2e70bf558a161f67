"""The port's exact-mode log-mel (a2m_torch/audio/frontend.py with
``exact=True``; on the CPU the float64 plain version of K2x) against a2m.

Held within 1e-5 (a2m's ``PARITY_TOL``, tests/test_audio_frontend.py:16) of
a2m's float64 numpy golden (``a2m.audio.mel_np``), of a2m's exact XLA path
(``frontend.log_mel(..., exact=True)``) and of a2m's exact Pallas kernel in
interpret mode, for the three families; the tonal case within the dynamic
range a2m's own tonal test uses.  Also: the exact tables are float64 and
rebuild the float64 filterbank, the numpy mirror of the kernel's data path
(``test_torch_mel_fft.py``) run in float64 is the real FFT to 1e-9 and the
golden to 1e-5, and the serving entry points stay on fast mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

from a2m.audio import frontend as jfe
from a2m.audio import mel_np as jmel_np
from a2m.audio.pallas_mel import pallas_log_mel
from a2m_torch.audio import frontend, mel_kernel, mel_np
from test_torch_mel_fft import _radix2, mirror, mirror_spectrum

SR = 45600
PARITY_TOL = 1e-5
FAMILIES = ('log_mel_512', 'log_mel_400', 'vggish')


@pytest.fixture(scope='module')
def clip():
    rng = np.random.default_rng(42)
    return (rng.standard_normal(int(SR * 4.3)) * 0.1).astype(np.float64)


@pytest.fixture(scope='module')
def clip16(clip):
    return jmel_np.resample(clip, SR, 16000)


def _input(family, clip, clip16):
    """(float64 waveform, its rate) of a family's golden."""
    return (clip, SR) if family == 'log_mel_512' else (clip16, 16000)


def _golden(family, y, sr):
    if family == 'log_mel_512':
        return jmel_np.log_mel_512(y, sr)
    if family == 'log_mel_400':
        return jmel_np.log_mel_400(y, sr)     # 16 kHz in: no resample
    return jmel_np.vggish_log_mel(y, sr)


def _port(family, y32):
    y = torch.from_numpy(y32)
    if family == 'log_mel_512':
        return frontend.log_mel_512(y, SR).numpy()
    if family == 'log_mel_400':
        return frontend.log_mel_400(y).numpy()
    return frontend.vggish_log_mel(y).numpy()


@pytest.mark.parametrize('family', FAMILIES)
def test_exact_matches_float64_golden(family, clip, clip16):
    y, sr = _input(family, clip, clip16)
    got = _port(family, y.astype(np.float32))
    ref = _golden(family, y, sr)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() < PARITY_TOL


def test_tonal_parity_within_dynamic_range():
    """a2m's tonal case (tests/test_audio_frontend.py:129-140), held at
    1e-5 over the mels within 120 dB of the peak (a2m's XLA path meets
    5e-5 there)."""
    t = np.linspace(0, 4.3, int(SR * 4.3))
    y = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3
                                                              * t))
    g = jmel_np.log_mel_512(y, SR)
    got = frontend.log_mel_512(torch.from_numpy(y.astype(np.float32)),
                               SR).numpy()
    mel_g = np.exp(g)
    mask = mel_g > 1e-6 * mel_g.max()
    assert mask.sum() > 1000          # a tone: ~5% of the mels
    assert np.abs(g - got)[mask].max() < PARITY_TOL


@pytest.mark.parametrize('family', FAMILIES + ('constant_pad',))
def test_exact_matches_a2m_exact(family, clip, clip16):
    """a2m's exact XLA path (hi/lo split matrices, precise log) on the same
    f32 samples; ``constant_pad`` is log_mel_512 with a zero centred pad."""
    fam = 'log_mel_512' if family == 'constant_pad' else family
    y = _input(fam, clip, clip16)[0][:3 * 16000].astype(np.float32)
    spec = {'log_mel_512': lambda m: m.spec_log_mel_512(SR),
            'log_mel_400': lambda m: m.spec_log_mel_400(),
            'vggish': lambda m: m.spec_vggish()}[fam]
    pspec, jspec = spec(frontend), spec(jfe)
    if family == 'constant_pad':
        pspec = dataclasses.replace(pspec, pad_mode='constant')
        jspec = dataclasses.replace(jspec, pad_mode='constant')
    got = frontend.log_mel(torch.from_numpy(y[None]), pspec).numpy()
    ref = np.asarray(jfe.log_mel(y[None], jspec, exact=True))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < PARITY_TOL


def test_constant_pad_frames_match_golden_stft():
    """The zero centred pad against the float64 numpy STFT with
    ``pad_mode='constant'``, and the framed wire bit-equal to it."""
    rng = np.random.default_rng(4)
    y = (rng.standard_normal((1, SR)) * 0.1).astype(np.float32)
    spec = dataclasses.replace(frontend.spec_log_mel_512(SR),
                               pad_mode='constant')
    got = frontend.log_mel(torch.from_numpy(y), spec).numpy()[0]
    s = np.abs(jmel_np.stft_librosa(y[0].astype(np.float64), 2048, 512,
                                    pad_mode='constant')) ** 2
    ref = np.log(np.maximum(jmel_np.mel_matrix_slaney(128, 2048, SR) @ s,
                            1e-10)).T
    assert np.abs(got - ref).max() < PARITY_TOL
    framed = frontend.frame_for_wire(y, spec)
    assert torch.equal(frontend.log_mel_frames(torch.from_numpy(framed),
                                               spec)[0],
                       torch.from_numpy(got))


def test_matches_a2m_exact_pallas_kernel_interpret():
    """a2m's exact Pallas kernel in interpret mode: log_mel_400, 1 s at
    16 kHz."""
    y = (np.random.default_rng(3).standard_normal((1, 16000))
         * 0.1).astype(np.float32)
    ref = np.asarray(pallas_log_mel(y, jfe.spec_log_mel_400(), exact=True))
    got = frontend.log_mel_400(torch.from_numpy(y)).numpy()
    assert got.shape == ref.shape == (1, 97, 64)
    assert np.abs(got - ref).max() < PARITY_TOL


@pytest.mark.parametrize('family', FAMILIES)
def test_exact_tables_are_float64(family):
    spec = {'log_mel_512': frontend.spec_log_mel_512(SR),
            'log_mel_400': frontend.spec_log_mel_400(),
            'vggish': frontend.spec_vggish()}[family]
    t = frontend.fft_tables(spec, exact=True)
    dense = frontend.dft_matrices(spec, exact=True)
    assert all(t[k].dtype == np.float64
               for k in ('window', 'twiddle', 'mel_weights'))
    assert all(dense[k].dtype == np.float64 for k in ('dr', 'di', 'mel'))
    # the float64 filterbank, rebuilt from its nonzeros, bit for bit
    k_bins = spec.n_fft // 2 + 1
    if spec.mel_scale == 'htk':
        mel = mel_np.mel_matrix_htk(spec.n_mels, k_bins, spec.sr, spec.fmin,
                                    spec.fmax)
    else:
        mel = mel_np.mel_matrix_slaney(spec.n_mels, spec.n_fft, spec.sr,
                                       fmin=spec.fmin, fmax=spec.fmax,
                                       norm=spec.mel_norm).T
    rebuilt = np.zeros_like(mel)
    for j, (first, count, offset) in enumerate(t['mel_bins']):
        rebuilt[first:first + count, j] = t['mel_weights'][offset:offset
                                                          + count]
    np.testing.assert_array_equal(rebuilt, mel)
    ang = -2.0 * np.pi * np.arange(spec.n_fft // 2) / spec.n_fft
    np.testing.assert_array_equal(t['twiddle'][:, 0], np.cos(ang))
    np.testing.assert_array_equal(t['twiddle'][:, 1], np.sin(ang))
    # the CPU tables carry them as they are; a CUDA device only the kernel's
    tables = frontend.mel_tables(spec, 'cpu', True)
    assert tables.exact and tables.mel.dtype == torch.float64
    assert not frontend.mel_tables(spec, 'cpu').exact


@pytest.mark.parametrize('family', FAMILIES)
def test_float64_mirror_is_the_real_fft(family):
    """K2x's data path (numpy mirror, the kernel's radix-2 stages in
    float64) against ``rfft`` of the windowed frames at every bin."""
    spec = {'log_mel_512': frontend.spec_log_mel_512(SR),
            'log_mel_400': frontend.spec_log_mel_400(),
            'vggish': frontend.spec_vggish()}[family]
    y = (np.random.default_rng(7).standard_normal((2, 6000))
         + 0.3).astype(np.float32)
    x, p = mirror_spectrum(y, spec, 4, 'radix2', exact=True)
    assert x.dtype == np.float64 and p.dtype == np.float64
    ref = np.abs(np.fft.rfft(x)) ** spec.power
    assert np.abs(p - ref).max() / ref.max() < 1e-9


@pytest.mark.parametrize('family', FAMILIES)
def test_float64_mirror_matches_golden(family, clip, clip16):
    y, sr = _input(family, clip, clip16)
    y = y[:2 * 16000]
    spec = {'log_mel_512': frontend.spec_log_mel_512(SR),
            'log_mel_400': frontend.spec_log_mel_400(),
            'vggish': frontend.spec_vggish()}[family]
    n_frames = frontend.num_frames(spec, len(y))
    got = mirror(y.astype(np.float32)[None], spec, n_frames, 'radix2',
                 exact=True)[0]
    ref = _golden(family, y, sr)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < PARITY_TOL


def test_radix2_in_float64():
    rng = np.random.default_rng(8)
    z = rng.standard_normal((2, 1024)) + 1j * rng.standard_normal((2, 1024))
    got = _radix2(z, frontend.twiddles(2048, np.float64))
    assert got.dtype == np.complex128
    assert np.abs(got - np.fft.fft(z)).max() < 1e-12 * np.abs(z).sum()


def test_serving_entry_points_stay_on_fast_mode():
    """Every serving call site passes ``exact=False`` (a missed one would
    move serving onto K2x): the one-window path, the streaming server on
    its waveform, chunked and framed routes."""
    from a2m_torch.config import GeneratorConfig
    from a2m_torch.eval import streaming
    from a2m_torch.models.generator import Generator
    from a2m_torch.pipeline import audio_to_pose_fn

    seen = []
    real = mel_kernel.log_mel

    def spy(y, tables, *args, **kw):
        seen.append(tables.exact)
        return real(y, tables, *args, **kw)

    torch.manual_seed(0)
    model = Generator(GeneratorConfig(in_channels=16, out_channels=16,
                                      joint_feat_dim=8, gat_heads=2)).eval()
    rng = np.random.default_rng(5)
    waves = [(rng.standard_normal(SR * 3) * 0.1).astype(np.float32)
             for _ in range(2)]
    mel_kernel.log_mel = spy
    try:
        audio_to_pose_fn(model, 'cpu')(torch.from_numpy(np.stack(waves)))
        streaming.stream_from_waveforms(model, waves, SR, fused=True)
        streaming.stream_from_waveforms(model, waves, SR, fused=False)
        streaming.stream_from_waveforms(
            model, streaming.frame_streams_for_wire(waves, SR), SR,
            framed_n_samples=SR * 3)
    finally:
        mel_kernel.log_mel = real
    assert len(seen) >= 4 and not any(seen)
