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
    return frontend.log_mel(torch.from_numpy(clip[None]), spec6,
                            exact=False).numpy()


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
                           spec6, exact=False, n_frames=8)
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


# ---- the 400 / VGGish families, num_frames, the framed wire ----------------

SPECS = {'log_mel_512': (lambda m: m.spec_log_mel_512(SR)),
         'log_mel_400': (lambda m: m.spec_log_mel_400()),
         'vggish': (lambda m: m.spec_vggish())}


@pytest.fixture(scope='module')
def clip16k():
    return (np.random.default_rng(1).standard_normal(16000) * 0.1).astype(
        np.float32)


@pytest.mark.parametrize('family', ['log_mel_400', 'vggish'])
@pytest.mark.parametrize('stride', [1, 7], ids=['full_rate', 'pose_rate'])
def test_400_family_matches_a2m_fast_mode(clip16k, family, stride):
    """Magnitude spectrum, 64 mels, uncentred frames; VGGish adds 400-sample
    frames, htk mels and the offset log.  Stride 1 overlaps frames (hop 160
    < frame_len), stride 7 is the pose-rate spec of the serving path."""
    spec = frontend.strided_spec(SPECS[family](frontend), stride)
    jspec = jfe.strided_spec(SPECS[family](jfe), stride)
    got = frontend.log_mel(torch.from_numpy(clip16k[None]), spec,
                           exact=False).numpy()
    ref = np.asarray(jfe.log_mel(clip16k[None], jspec, exact=False))
    assert got.shape == ref.shape and got.shape[-1] == 64
    assert np.abs(got - ref).max() < 1e-4


@pytest.mark.parametrize('family', ['log_mel_400', 'vggish'])
def test_400_family_constants_match_a2m(family):
    got = frontend.dft_matrices(SPECS[family](frontend))
    ref = jfe.dft_matrices(SPECS[family](jfe))
    assert got['frame_len'] == ref['frame_len'] == (
        400 if family == 'vggish' else 512)
    assert got['K'] == ref['K'] == 257
    for port_key, ref_key in (('dr', 'drh'), ('di', 'dih'), ('mel', 'melh')):
        np.testing.assert_array_equal(got[port_key], ref[ref_key])


@pytest.mark.parametrize('family', sorted(SPECS))
@pytest.mark.parametrize('n_samples', [16000, 16399, 16400, 45600 * 6])
def test_num_frames_matches_a2m(family, n_samples):
    """An uncentred spec counts frames of ``frame_len`` samples, which is
    the window (400), not n_fft (512), under VGGish framing."""
    for stride in (1, 6):
        spec = frontend.strided_spec(SPECS[family](frontend), stride)
        jspec = jfe.strided_spec(SPECS[family](jfe), stride)
        assert frontend.num_frames(spec, n_samples) == \
            jfe.num_frames(jspec, n_samples)
    if family == 'vggish':
        assert frontend.num_frames(SPECS[family](frontend), 16400) == 101


@pytest.mark.parametrize('family,dtype,tail', [
    ('log_mel_512', np.float32, 0), ('log_mel_512', np.int16, 0),
    ('log_mel_512', np.uint8, 128), ('vggish', np.float32, 0),
    ('log_mel_400', np.int16, 0)])
def test_frame_for_wire_equals_a2m(family, dtype, tail):
    rng = np.random.default_rng(2)
    sr = SR if family == 'log_mel_512' else 16000
    y = rng.standard_normal((2, sr)) * 0.1
    y = (y * 32767).astype(dtype) if dtype != np.float32 else y.astype(dtype)
    stride = 6 if family == 'log_mel_512' else 7
    spec = frontend.strided_spec(SPECS[family](frontend), stride)
    jspec = jfe.strided_spec(SPECS[family](jfe), stride)
    # one frame more than the signal holds: the tail is padded
    n = frontend.num_frames(spec, y.shape[-1]) + 1
    for n_frames in (None, n):
        got = frontend.frame_for_wire(y, spec, n_frames, tail_value=tail)
        ref = jfe.frame_for_wire(y, jspec, n_frames, tail_value=tail)
        assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    if tail:
        assert (got[:, -1, -8:] == tail).all()


@pytest.mark.parametrize('family', sorted(SPECS))
@pytest.mark.parametrize('pcm', [False, True], ids=['f32', 'int16'])
def test_framed_entry_equals_waveform_entry_bitwise(family, pcm):
    rng = np.random.default_rng(3)
    sr = SR if family == 'log_mel_512' else 16000
    y = (rng.standard_normal((2, 2 * sr)) * 0.1).astype(np.float32)
    if pcm:
        y = (y * 32767).astype(np.int16)
    stride = 6 if family == 'log_mel_512' else 7
    spec = frontend.strided_spec(SPECS[family](frontend), stride)
    framed = frontend.frame_for_wire(y, spec)
    got = frontend.log_mel_frames(torch.from_numpy(framed), spec,
                                  exact=False)
    ref = frontend.log_mel(torch.from_numpy(y), spec, exact=False)
    assert got.shape == ref.shape == (2, frontend.num_frames(spec, 2 * sr),
                                      spec.n_mels)
    assert torch.equal(got, ref)
    jref = np.asarray(jfe.log_mel_frames(
        framed, jfe.strided_spec(SPECS[family](jfe), stride), exact=False))
    assert np.abs(got.numpy() - jref).max() < 1e-4


def test_unsupported_specs_are_refused():
    import dataclasses
    base = frontend.spec_log_mel_512(SR)
    for change in (dict(pad_mode='edge'), dict(power=3.0),
                   dict(log_mode='db'), dict(n_mels=256)):
        with pytest.raises(NotImplementedError):
            frontend.log_mel(torch.zeros(1, SR),
                             dataclasses.replace(base, **change))
    with pytest.raises(ValueError, match='frames of'):
        mel_kernel.log_mel_framed(
            torch.zeros(1, 3, 512), frontend.mel_tables(base, 'cpu'), 1e-10)


# ---- waveforms shorter than the centred pad --------------------------------

@pytest.mark.parametrize('stride,exact', [(STRIDE, False), (1, True)],
                         ids=['pose_rate_fast', 'log_mel_512_exact'])
@pytest.mark.parametrize('n', [1, 2, 500, 1024, 1025])
def test_short_waveform_matches_a2m(n, stride, exact):
    """A pad of 1024 samples reflects again once it outgrows the signal
    (numpy's and ``jnp.pad``'s mode='reflect'; one sample repeats): the
    port gives a2m's shapes and values on serving's pose-rate spec in fast
    mode (1e-4: direct vs radix DFT in f32) and on the data path's
    log_mel_512 in exact mode (1e-5)."""
    y = (np.random.default_rng(n).standard_normal((2, n)) * 0.1).astype(
        np.float32)
    spec = frontend.strided_spec(frontend.spec_log_mel_512(SR), stride)
    jspec = jfe.strided_spec(jfe.spec_log_mel_512(SR), stride)
    got = frontend.log_mel(torch.from_numpy(y), spec, exact=exact).numpy()
    ref = np.asarray(jfe.log_mel(y, jspec, exact=exact))
    assert got.shape == ref.shape == (2, 1 + n // (512 * stride), 128)
    assert np.abs(got - ref).max() < (1e-5 if exact else 1e-4)
    # the frames themselves: numpy's repeated reflection
    pad = 1024
    frames = mel_kernel.frames_of(torch.from_numpy(y), 2048, 512 * stride,
                                  pad, got.shape[1]).numpy()
    padded = np.pad(y, [(0, 0), (pad, pad)], mode='reflect')
    np.testing.assert_array_equal(frames[:, 0, :min(2048, padded.shape[1])],
                                  padded[:, :2048])
