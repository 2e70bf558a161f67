"""Host tables and data path of the log-mel FFT kernel (a2m_torch/csrc/
log_mel.cu), on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` holds it to
``mel_kernel.log_mel_plain`` there).  Here the tables it reads are held to
what they stand for, and a numpy mirror of its data path (gather with the
reflect pad and zero tail, window, even/odd packing into n_fft/2 complex
points, an FFT of them, the real-input split with the twiddle table, power
or magnitude, the mel over the filterbank's nonzeros, log) to the plain
direct DFT.  The mirror's FFT is ``np.fft.fft`` or a copy of the kernel's
own radix-2 stages (bit-reversed load, stage twiddles read from the
table).  Tolerance 1e-4 in log units: an FFT and a direct DFT compute the
same f32 function in another order (as ``test_torch_frontend.py`` holds the
plain version to a2m's radix DFT).  The mirror also runs in float64 on the
exact tables, the data path of K2x (``tests/test_torch_mel_exact.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from a2m_torch.audio import frontend, mel_kernel

SR = 45600
FAMILIES = {'log_mel_512': lambda: frontend.spec_log_mel_512(SR),
            'log_mel_400': frontend.spec_log_mel_400,
            'vggish': frontend.spec_vggish}
# (family, stride): stride 1 overlaps frames (hop < frame_len); the pose-rate
# strides of the serving path give hops larger than the frame
RATES = [('log_mel_512', 1), ('log_mel_512', 6), ('log_mel_400', 1),
         ('log_mel_400', 7), ('vggish', 1), ('vggish', 7)]


def _spec(family, stride):
    return frontend.strided_spec(FAMILIES[family](), stride)


@pytest.mark.parametrize('family,stride', RATES)
def test_sparse_mel_rebuilds_dense(family, stride):
    spec = _spec(family, stride)
    dense = frontend.dft_matrices(spec)['mel']
    t = frontend.fft_tables(spec)
    bins, weights = t['mel_bins'], t['mel_weights']
    assert bins.dtype == np.int32 and bins.shape == (spec.n_mels, 3)
    assert weights.dtype == np.float32
    rebuilt = np.zeros_like(dense)
    for j, (first, count, offset) in enumerate(bins):
        rebuilt[first:first + count, j] = weights[offset:offset + count]
    np.testing.assert_array_equal(rebuilt, dense)
    # offsets run on without gaps; only nonzeros between a mel's ends kept
    assert (bins[1:, 2] == bins[:-1, 2] + bins[:-1, 1]).all()
    assert weights.size == bins[-1, 2] + bins[-1, 1] < dense.size // 20


@pytest.mark.parametrize('n_fft', [4, 512, 2048])
def test_twiddles_within_one_ulp(n_fft):
    tw = frontend.twiddles(n_fft)
    assert tw.dtype == np.float32 and tw.shape == (n_fft // 2, 2)
    ref = np.exp(-2j * np.pi * np.arange(n_fft // 2) / n_fft)
    for got, want in ((tw[:, 0], ref.real), (tw[:, 1], ref.imag)):
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got.astype(np.float64) - want) <= ulp).all()


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_window_as_the_frame_sees_it(family):
    """Centred inside n_fft for log_mel_400, zero past the 400 samples of a
    VGGish frame, the whole frame for log_mel_512."""
    spec = FAMILIES[family]()
    w = frontend.fft_tables(spec)['window']
    assert w.shape == (spec.n_fft,) and w.dtype == np.float32
    nz = np.flatnonzero(w)
    off = {'log_mel_512': 0, 'log_mel_400': 56, 'vggish': 0}[family]
    assert nz[0] == off + 1 and nz[-1] == off + spec.win_length - 1


def _radix2(z, tw):
    """The kernel's FFT of the last axis (m points) in ``z``'s type:
    bit-reversed load, then radix-2 decimation-in-time stages, stage s
    reading twiddle entry j << (log2 m - s) of the n_fft-point table.  (The
    kernel runs stages s and s + 1 as one pass over 4 points: the same
    operations.)"""
    m = z.shape[-1]
    log2m = m.bit_length() - 1
    rev = np.array([int(f'{p:0{log2m}b}'[::-1], 2) for p in range(m)])
    out = np.empty_like(z)
    out[..., rev] = z
    w_tab = tw[:, 0] + 1j * tw[:, 1]
    bf = np.arange(m // 2)
    for s in range(log2m):
        h = 1 << s
        j = bf & (h - 1)
        i0 = ((bf >> s) << (s + 1)) + j
        w = w_tab[j << (log2m - s)].astype(z.dtype)
        a, c = out[..., i0], out[..., i0 + h] * w
        out[..., i0], out[..., i0 + h] = a + c, a - c
    return out


def _reflect(s, n):
    """The kernel's ``reflect``: reflect at either end until inside (one
    sample repeats)."""
    if n == 1:
        return np.zeros_like(s)
    while ((s < 0) | (s >= n)).any():
        s = np.where(s < 0, -s, np.where(s >= n, 2 * (n - 1) - s, s))
    return s


def mirror_spectrum(y, spec, n_frames, fft='numpy', exact=False):
    """numpy copy of the kernel's data path up to the power (or magnitude)
    of bins 0..n_fft/2: (B, N) f32 -> ((B, T, n_fft) windowed frames,
    (B, T, n_fft/2 + 1) spectrum), in f32 (K2) or in float64 on the exact
    tables (K2x)."""
    real = np.float64 if exact else np.float32
    cplx = np.complex128 if exact else np.complex64
    t = frontend.fft_tables(spec, exact)
    window, tw = t['window'], t['twiddle']
    frame_len, n_fft = t['frame_len'], spec.n_fft
    m = n_fft // 2
    n_samples = y.shape[-1]
    pad = n_fft // 2 if spec.center else 0
    s = (np.arange(n_frames)[:, None] * spec.hop_length
         + np.arange(n_fft)[None, :])
    valid = (np.arange(n_fft)[None, :] < frame_len) & (s < n_samples
                                                      + 2 * pad)
    s = _reflect(np.where(valid, s, 0) - pad, n_samples)
    x = np.where(valid, y[:, s], 0).astype(real)
    x = x_frames = x * window
    z = (x[..., 0::2] + 1j * x[..., 1::2]).astype(cplx)
    z = np.fft.fft(z).astype(cplx) if fft == 'numpy' else _radix2(z, tw)
    k = np.arange(m + 1)
    a, c = z[..., k % m], np.conj(z[..., (m - k) % m])
    w = np.append(tw[:, 0] + 1j * tw[:, 1], -1).astype(cplx)
    x = 0.5 * (a + c) + w * (0.5 * (a - c) / 1j).astype(cplx)
    p = (x.real * x.real + x.imag * x.imag).astype(real)
    if spec.power == 1.0:
        p = np.sqrt(p)
    return x_frames, p


def mirror(y, spec, n_frames, fft='numpy', exact=False):
    """numpy copy of the kernel's data path, (B, N) f32 -> (B, T, n_mels),
    in f32 (K2) or float64 (K2x)."""
    t = frontend.fft_tables(spec, exact)
    _, p = mirror_spectrum(y, spec, n_frames, fft, exact)
    mel = np.zeros(p.shape[:-1] + (spec.n_mels,), p.dtype)
    for j, (first, count, offset) in enumerate(t['mel_bins']):
        mel[..., j] = p[..., first:first + count] @ \
            t['mel_weights'][offset:offset + count]
    c = p.dtype.type(spec.log_const)
    if spec.log_mode == 'offset':
        return np.log(mel + c)
    return np.log(np.maximum(mel, c))


# (family, stride, samples, extra frames): a short centred signal whose
# first and last frames reflect at both ends, the pose-rate hop larger than
# the frame, uncentred frames one past the signal (zero tail), VGGish's 400
# samples zero-padded to 512
MIRROR_CASES = [('log_mel_512', 1, 5000, 0), ('log_mel_512', 6, 3 * 3072
                                              + 1900, 0),
                ('log_mel_400', 1, 4000, 1), ('log_mel_400', 7, 16000, 0),
                ('vggish', 1, 4000, 1), ('vggish', 7, 16000, 0)]


@pytest.mark.parametrize('fft', ['numpy', 'radix2'])
@pytest.mark.parametrize('family,stride,n_samples,extra', MIRROR_CASES)
def test_mirror_matches_plain(family, stride, n_samples, extra, fft):
    spec = _spec(family, stride)
    rng = np.random.default_rng(5)
    y = (rng.standard_normal((2, n_samples)) * 0.1).astype(np.float32)
    n_frames = frontend.num_frames(spec, n_samples) + extra
    got = mirror(y, spec, n_frames, fft)
    ref = frontend.log_mel(torch.from_numpy(y), spec, exact=False,
                           n_frames=n_frames).numpy()
    assert got.shape == ref.shape == (2, n_frames, spec.n_mels)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() < 1e-4


@pytest.mark.parametrize('fft', ['numpy', 'radix2'])
@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_split_gives_every_bin(family, fft):
    """The real-input split against ``rfft`` of the windowed frames, bins 0
    and n_fft/2 included (the mel filterbanks give both zero weight, so the
    log-mel cannot see them)."""
    spec = FAMILIES[family]()
    y = (np.random.default_rng(7).standard_normal((2, 6000)) + 0.3).astype(
        np.float32)
    x, p = mirror_spectrum(y, spec, 4, fft)
    ref = np.abs(np.fft.rfft(x.astype(np.float64))) ** spec.power
    assert p.shape == ref.shape == (2, 4, spec.n_fft // 2 + 1)
    err = np.abs(p - ref) / ref.max()
    assert err.max() < 1e-5
    assert err[..., 0].max() < 1e-6 and err[..., -1].max() < 1e-6


def test_radix2_is_a_dft():
    """The kernel's stage indexing gives the DFT for every size it takes."""
    rng = np.random.default_rng(6)
    for n_fft in (4, 8, 64, 512, 2048):
        z = (rng.standard_normal((3, n_fft // 2))
             + 1j * rng.standard_normal((3, n_fft // 2))).astype(np.complex64)
        got = _radix2(z, frontend.twiddles(n_fft))
        ref = np.fft.fft(z.astype(np.complex128))
        assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize('n_fft,frame_len,n_mels', [
    (2048, 2048, 128), (512, 512, 64), (512, 400, 64), (4, 4, 1)])
def test_kernel_shapes_taken(n_fft, frame_len, n_mels):
    mel_kernel.check_kernel_shapes(n_fft, frame_len, n_mels)


@pytest.mark.parametrize('n_fft,frame_len,n_mels', [
    (4096, 4096, 128), (1000, 1000, 64), (2, 2, 1), (0, 0, 1),
    (512, 513, 64), (512, 400, 129), (2048, 2048, 0)])
def test_kernel_shapes_refused(n_fft, frame_len, n_mels):
    with pytest.raises(ValueError):
        mel_kernel.check_kernel_shapes(n_fft, frame_len, n_mels)


def test_cpu_tables_need_the_dense_matrices():
    tables = frontend.mel_tables(frontend.spec_vggish(), 'cpu')
    assert tables.dr is not None and tables.n_fft == 512
    kernel_only = dataclasses.replace(tables, dr=None, di=None, mel=None)
    with pytest.raises(ValueError, match='dense'):
        mel_kernel.log_mel(torch.zeros(1, 4000), kernel_only, 160, 0, 10,
                           0.01, 1.0, 'offset')


def test_function_bound_is_bytes_at_the_serving_shapes():
    """Counted over the filterbank's nonzeros, the function needs far less
    than its bytes take at 67 TFLOP/s against 3.35 TB/s."""
    spec = frontend.strided_spec(FAMILIES['log_mel_512'](), 6)
    t = frontend.fft_tables(spec)
    nnz = t['mel_weights'].size
    assert nnz == 2013
    for batch, n_samples, n_frames in ((128, 196080, 64),
                                       (8, 2736000, 891)):
        flops = mel_kernel.log_mel_flops(batch, n_frames, 2048, nnz, 128)
        nbytes = mel_kernel.log_mel_bytes(batch, n_samples, n_frames, 2048,
                                          3072, 2048, nnz, 128)
        assert flops / 67e12 < nbytes / 3.35e12
        run = mel_kernel.fft_kernel_flops(batch, n_frames, 2048, nnz, 128)
        assert flops < run < 2 * flops
