"""CPU mirror of K2x's design (a2m_torch/csrc/log_mel_exact.cu), in float64.

The kernel runs only on the card (``chip_smoke.py`` phase 10 holds it to
``mel_kernel.log_mel_plain`` in float64 there).  Here a numpy copy of its
schedule is held to what it stands for: the Stockham passes of
``mel_kernel.exact_plan`` with each thread's points in registers and the
twiddle tables of ``mel_kernel.exact_twiddles`` read as the kernel reads
them, the real-input split from the registers each thread ends with, the
shared-memory layout of the exchanges between passes (a permutation, free
of bank conflicts for 16-byte points), the balanced mel schedule of
``mel_kernel.mel_schedule``, and the whole data path against the plain
version in float64, a2m's float64 golden and a2m's exact Pallas kernel
(interpret mode) at a2m's exact-mode tolerance, 1e-5.  Change the kernel's
schedule and this mirror together.
"""

import numpy as np
import pytest
import torch

from a2m.audio import frontend as jfe
from a2m.audio import mel_np as jmel_np
from a2m.audio.pallas_mel import pallas_log_mel
from a2m_torch.audio import frontend, mel_kernel
from test_torch_mel_fft import mirror_spectrum

SR = 45600
PARITY_TOL = 1e-5
N_FFTS = [4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048]
FAMILIES = {'log_mel_512': lambda: frontend.spec_log_mel_512(SR),
            'log_mel_400': frontend.spec_log_mel_400,
            'vggish': frontend.spec_vggish}


@pytest.fixture(autouse=True)
def two_threads():
    """At most two intra-op threads while a test of this module runs (the
    mirror is many small numpy and torch steps), restored after it: other
    modules' tests in the same worker keep their own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def sub(t, s, plan, last):
    """Sub-butterfly of slot ``s`` of frame-thread ``t`` in a pass (the
    kernel's ``sub_butterfly``).  Before the last pass slot s is t + tpf s.
    In the last pass (p = m / R sub-butterflies, S = 16 / R slots a thread)
    slot 2v is t + 2 tpf v and slot 2v + 1 is p - t - 2 tpf v, so a thread
    holds bins k and m - k together; thread 0 holds 2 tpf v and tpf (S - 1
    - 2v) instead (0 and p / 2 pair with themselves)."""
    tpf, m = plan['tpf'], plan['m']
    if not last or tpf == 1:
        return t + tpf * s
    p = m // plan['radices'][-1]
    n_slots = plan['points'] // plan['radices'][-1]
    v = s >> 1
    if s & 1:
        return np.where(t == 0, tpf * (n_slots - 1 - 2 * v),
                        (p - t - 2 * tpf * v) % p)
    return t + 2 * tpf * v


def exchange_slot(a, first):
    """16-byte slot of point ``a`` of a frame in shared memory: the first
    exchange pads one slot every 16 points (pass 1 writes points 16
    apart); later exchanges, whose reads run backwards across such pads
    for half of the last pass's slots, are linear."""
    return a + (a >> 4) if first else a


def split_constants(r):
    """``exp(-pi i j / r)`` for j < r, the kernel's constants (exact where
    the value is 0 or 1)."""
    c = np.exp(-1j * np.pi * np.arange(r) / r)
    return np.where(np.abs(c.real) < 1e-15, 1j * c.imag,
                    np.where(np.abs(c.imag) < 1e-15, c.real, c))


def mirror_fft(z, n_fft, trace=None):
    """The kernel's FFT of (F, m) complex points: returns (F, tpf, S, R)
    complex, thread t's register (s, j) holding X[sub(t, s) + p j] of the
    last pass.  ``trace`` collects (exchange, write?, t, register, point)
    for the layout test."""
    plan = mel_kernel.exact_plan(n_fft)
    m, tpf, pts, radices = (plan[k] for k in ('m', 'tpf', 'points',
                                              'radices'))
    tw = mel_kernel.exact_twiddles(n_fft)
    tw = tw[:, 0] + 1j * tw[:, 1]
    t = np.arange(tpf)
    buf = z
    p, off = 1, 0
    for q, r in enumerate(radices):
        n_slots, last = pts // r, q == len(radices) - 1
        i = np.stack([sub(t, s, plan, last) for s in range(n_slots)], 1)
        src = i[:, :, None] + (m // r) * np.arange(r)       # (tpf, S, R)
        regs = buf[:, src]
        if trace is not None and q:
            for tt, reg, a in zip(*np.broadcast_arrays(
                    t[:, None], np.arange(pts)[None], src.reshape(tpf, pts))):
                for x in zip(tt, reg, a):
                    trace.append((q - 1, False) + tuple(map(int, x)))
        if q:
            k = i % p
            regs[..., 1:] *= tw[off + (np.arange(1, r) - 1)[None, None]
                                * p + k[..., None]]
            off += (r - 1) * p
        regs = np.fft.fft(regs, axis=-1)
        if last:
            return regs, plan, tw[off:]
        k = i % p
        dst = ((i - k) * r + k)[..., None] + p * np.arange(r)
        buf = np.empty_like(buf)
        buf[:, dst] = regs
        if trace is not None:
            for tt, reg, a in zip(*np.broadcast_arrays(
                    t[:, None], np.arange(pts)[None], dst.reshape(tpf, pts))):
                for x in zip(tt, reg, a):
                    trace.append((q, True) + tuple(map(int, x)))
        p *= r


def partner(t0, s, j, plan):
    """Register (s', j') of the same thread holding bin m - k of register
    (s, j): thread 0's own pairing, or every other thread's."""
    r = plan['radices'][-1]
    n_slots = plan['points'] // r
    if not t0:
        return (s ^ 1 if n_slots > 1 else s), r - 1 - j
    v = s >> 1
    if s & 1:
        return 2 * (n_slots // 2 - 1 - v) + 1, r - 1 - j
    if v == 0:
        return 0, (r - j) % r
    return 2 * (n_slots // 2 - v), r - 1 - j


def bin_power(a, c, w, magnitude):
    """The kernel's ``bin_power``: bin k from Z[k], Z[m - k], W^k."""
    er, ei = 0.5 * (a.real + c.real), 0.5 * (a.imag - c.imag)
    o_r, o_i = 0.5 * (a.imag + c.imag), -0.5 * (a.real - c.real)
    xr = er + (w.real * o_r - w.imag * o_i)
    xi = ei + (w.real * o_i + w.imag * o_r)
    p = xr * xr + xi * xi
    return np.sqrt(p) if magnitude else p


def mirror_power(z, n_fft, magnitude=False):
    """(F, m) packed points -> (F, m + 1) power (or magnitude) as the
    kernel's split computes it: every register its own bin k from the
    register ``partner`` names and W^k, the sub-butterfly's table entry
    times a constant; thread 0 also bin m from Z[0]."""
    regs, plan, tws = mirror_fft(z, n_fft)
    m, tpf, r = plan['m'], plan['tpf'], plan['radices'][-1]
    n_slots, p = plan['points'] // r, m // r
    const = split_constants(r)
    pw = np.full((z.shape[0], m + 1), np.nan)
    for t in range(tpf):
        for s in range(n_slots):
            i = int(sub(np.array(t), s, plan, True))
            for j in range(r):
                s2, j2 = partner(t == 0, s, j, plan)
                k = i + p * j
                assert np.isnan(pw[0, k])
                pw[:, k] = bin_power(regs[:, t, s, j], regs[:, t, s2, j2],
                                     tws[i] * const[j], magnitude)
    a = regs[:, 0, 0, 0]
    pw[:, m] = bin_power(a, a, -1.0 + 0j, magnitude)
    assert not np.isnan(pw).any()
    return pw


def bin_slot(k):
    """The kernel's slot of bin k: a pad double every 16 bins."""
    return k + (k >> 4)


def mirror_mel(pw, tables, spec):
    """The mel schedule: each thread's bins' nonzeros into two running
    sums picked by the mel's parity, partial sums where a mel ends; then
    each mel's pieces in order, and the log."""
    weights, index, pieces = mel_kernel.mel_schedule(
        tables['mel_bins'], tables['mel_weights'], spec.n_fft)
    m = spec.n_fft // 2
    slots = np.zeros((pw.shape[0], bin_slot(m) + 1))
    slots[:, bin_slot(np.arange(m + 1))] = pw
    part = np.zeros((pw.shape[0], pieces[-1]))
    for t in range(weights.shape[1]):
        acc = [np.zeros(pw.shape[0]), np.zeros(pw.shape[0])]
        for q in range(weights.shape[0]):
            odd, end = index[q, t] >> 15 & 1, index[q, t] >> 16
            total = acc[odd] + slots[:, index[q, t] & 0x7fff] * weights[q, t]
            if end:
                part[:, end - 1] = total
            acc[odd] = np.zeros(pw.shape[0]) if end else total
    mel = np.stack([part[:, pieces[j]:pieces[j + 1]].sum(1)
                    for j in range(spec.n_mels)], 1)
    if spec.log_mode == 'offset':
        return np.log(mel + spec.log_const)
    return np.log(np.maximum(mel, spec.log_const))


def mirror(y, spec, n_frames):
    """The whole data path of K2x: (B, N) f32 -> (B, T, n_mels) float64."""
    x, _ = mirror_spectrum(y, spec, n_frames, exact=True)
    z = (x[..., 0::2] + 1j * x[..., 1::2]).reshape(-1, spec.n_fft // 2)
    pw = mirror_power(z, spec.n_fft, spec.power == 1.0)
    out = mirror_mel(pw, frontend.fft_tables(spec, exact=True), spec)
    return out.reshape(y.shape[0], n_frames, spec.n_mels)


@pytest.mark.parametrize('n_fft', N_FFTS)
def test_plan_covers_the_fft(n_fft):
    plan = mel_kernel.exact_plan(n_fft)
    m = n_fft // 2
    assert int(np.prod(plan['radices'])) == m
    assert plan['tpf'] * plan['points'] == m
    assert plan['tpf'] * plan['lanes'] == mel_kernel.EXACT_GROUP
    # a frame that spans threads ends on a pass of radix 2, 4 or 8, so each
    # thread holds two or more sub-butterflies to pair
    if plan['tpf'] > 1:
        assert plan['radices'][-1] in (2, 4, 8)
    assert all(r == 16 for r in plan['radices'][:-2])
    tw = mel_kernel.exact_twiddles(n_fft)
    assert tw.dtype == np.float64 and tw.shape[1] == 2
    np.testing.assert_allclose(np.hypot(tw[:, 0], tw[:, 1]), 1.0,
                               atol=1e-15)


@pytest.mark.parametrize('n_fft', N_FFTS)
def test_fft_and_split_are_the_real_fft(n_fft):
    """Passes, twiddle tables and the split from registers give every bin
    of ``rfft`` of the frame, at 1e-12 relative."""
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal((3, n_fft)) + 0.2
    z = x[:, 0::2] + 1j * x[:, 1::2]
    regs, plan, _ = mirror_fft(z, n_fft)
    ref = np.fft.fft(z)
    m, r = plan['m'], plan['radices'][-1]
    p = m // r
    for t in range(plan['tpf']):
        for s in range(plan['points'] // r):
            k = int(sub(np.array(t), s, plan, True)) + p * np.arange(r)
            np.testing.assert_allclose(regs[:, t, s], ref[:, k], rtol=0,
                                       atol=1e-12 * np.abs(ref).max())
    for magnitude in (False, True):
        got = mirror_power(z, n_fft, magnitude)
        want = np.abs(np.fft.rfft(x)) ** (1 if magnitude else 2)
        assert np.abs(got - want).max() <= 1e-12 * want.max()


@pytest.mark.parametrize('n_fft', N_FFTS)
def test_each_thread_holds_its_split_pairs(n_fft):
    """After the last pass, bin m - k of every register's bin k lies in the
    same thread, in the register ``partner`` names."""
    plan = mel_kernel.exact_plan(n_fft)
    m, r = plan['m'], plan['radices'][-1]
    p, n_slots = m // r, plan['points'] // r
    seen = set()
    for t in range(plan['tpf']):
        bins = {(s, j): int(sub(np.array(t), s, plan, True)) + p * j
                for s in range(n_slots) for j in range(r)}
        for (s, j), k in bins.items():
            assert bins[partner(t == 0, s, j, plan)] == (m - k) % m
            seen.add(k)
    assert seen == set(range(m))


@pytest.mark.parametrize('n_fft', [512, 1024, 2048])
def test_exchanges_free_of_bank_conflicts(n_fft):
    """Every exchange between passes writes and reads each 8-thread
    wavefront (16-byte points: 8 to a 128-byte row of the 32 banks) in 8
    distinct bank groups (slots one to a point, within the frame's padded
    region), and so do the twiddle-table reads of every pass."""
    plan = mel_kernel.exact_plan(n_fft)
    m, tpf, lanes = plan['m'], plan['tpf'], plan['lanes']
    slots = np.arange(m)
    for first in (True, False):
        sw = exchange_slot(slots, first)
        assert len(set(sw.tolist())) == m and sw.max() < m + m // 16
    trace = []
    mirror_fft(np.zeros((1, m), complex), n_fft, trace)
    assert trace
    waves = {}
    for exchange, write, t, reg, a in trace:
        for lane in range(lanes):
            g = lane * tpf + t
            slot = lane * (m + m // 16) + exchange_slot(a, exchange == 0)
            waves.setdefault((exchange, write, reg, g // 8), set()).add(slot)
    for key, wave in waves.items():
        assert len(wave) <= 8
        assert len({x % 8 for x in wave}) == len(wave), key
    # twiddle tables: entry (j - 1) p + k of pass q, the split's entry i
    r_last = plan['radices'][-1]
    t = np.arange(tpf)
    p = plan['radices'][0]
    reads = []
    for q, r in enumerate(plan['radices'][1:], 1):
        last = q == len(plan['radices']) - 1
        for s in range(plan['points'] // r):
            i = sub(t, s, plan, last)
            reads += [(j - 1) * p + i % p for j in range(1, r)]
            if last:
                reads.append(i)
        p *= r
    assert r_last == r
    for idx in reads:
        for lane in range(lanes):
            for w in range(0, tpf, 8):
                wave = set(idx[w:w + 8].tolist())
                assert len({x % 8 for x in wave}) == len(wave)


def test_mel_schedule_covers_and_balances():
    """Every nonzero of each family's filterbank exactly once, each thread
    its own m / tpf bins (at most two nonzeros a bin: 32 a thread at most,
    ceil(nnz / tpf) at log_mel_512 and within 12% of it at 400 and VGGish),
    each mel's pieces consecutive, one a thread its bins meet."""
    for name, make in FAMILIES.items():
        spec = make()
        t = frontend.fft_tables(spec, exact=True)
        plan = mel_kernel.exact_plan(spec.n_fft)
        tpf, width = plan['tpf'], plan['m'] // plan['tpf']
        weights, index, pieces = mel_kernel.mel_schedule(
            t['mel_bins'], t['mel_weights'], spec.n_fft)
        nnz = t['mel_weights'].size
        held = (weights != 0).sum(0)
        assert weights.shape == index.shape and weights.shape[1] == tpf
        assert weights.shape[0] % 8 == 0 and held.sum() == nnz
        assert held.max() <= 2 * width
        assert held.max() <= 1.12 * -(-nnz // tpf)
        if name == 'log_mel_512':
            assert nnz == 2013 and held.max() == 32
        first, count, offset = t['mel_bins'].T
        seen = {}
        for th in range(tpf):
            for q in range(held[th]):
                slot = index[q, th] & 0x7fff
                k = slot - slot // 17
                assert bin_slot(k) == slot
                assert min(k // width, tpf - 1) == th
                mel = [j for j in range(spec.n_mels)
                       if first[j] <= k < first[j] + count[j]
                       and index[q, th] >> 15 & 1 == j & 1
                       and t['mel_weights'][offset[j] + k - first[j]]
                       == weights[q, th]]
                assert len(mel) >= 1
                seen[(mel[0], k)] = seen.get((mel[0], k), 0) + 1
        assert len(seen) == nnz and set(seen.values()) == {1}
        ends = index.ravel() >> 16
        assert sorted(ends[ends > 0]) == list(range(1, pieces[-1] + 1))
        assert pieces[0] == 0 and (np.diff(pieces) >= 0).all()
        assert pieces[-1] <= spec.n_mels + 2 * (tpf - 1)


# (family, stride, samples): waveforms shorter than the centred pad fold by
# the reflection at both ends; 6 is the pose-rate hop; the uncentred
# families need a frame's samples
PATH_CASES = ([('log_mel_512', s, n) for s in (1, 6)
               for n in (1, 2, 500, 1024, 9000)]
              + [(f, 1, n) for f in ('log_mel_400', 'vggish')
                 for n in (512, 9000)])


@pytest.mark.parametrize('family,stride,n', PATH_CASES)
def test_data_path_matches_plain_float64(family, stride, n):
    """Gather with the reflect pad, window, FFT, split, balanced mel and log
    against the plain version in float64 at 1e-5."""
    spec = frontend.strided_spec(FAMILIES[family](), stride)
    rng = np.random.default_rng(n + stride)
    y = (rng.standard_normal((2, n)) * 0.1).astype(np.float32)
    n_frames = frontend.num_frames(spec, n)
    got = mirror(y, spec, n_frames)
    ref = frontend.log_mel(torch.from_numpy(y), spec, exact=True).double()
    assert got.shape == tuple(ref.shape)
    assert np.abs(got - ref.numpy()).max() < PARITY_TOL


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_data_path_matches_a2m_golden(family):
    """Against a2m's float64 numpy golden (``mel_np``) on 1.5 s."""
    rng = np.random.default_rng(12)
    sr = SR if family == 'log_mel_512' else 16000
    y = rng.standard_normal(int(sr * 1.5)) * 0.1
    spec = FAMILIES[family]()
    n_frames = frontend.num_frames(spec, y.size)
    got = mirror(y.astype(np.float32)[None], spec, n_frames)[0]
    ref = {'log_mel_512': lambda: jmel_np.log_mel_512(y, sr),
           'log_mel_400': lambda: jmel_np.log_mel_400(y, sr),
           'vggish': lambda: jmel_np.vggish_log_mel(y, sr)}[family]()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < PARITY_TOL


def test_data_path_matches_a2m_exact_pallas_interpret():
    """Against a2m's exact Pallas kernel in interpret mode (log_mel_512,
    0.25 s)."""
    y = (np.random.default_rng(13).standard_normal((1, SR // 4))
         * 0.1).astype(np.float32)
    ref = np.asarray(pallas_log_mel(y, jfe.spec_log_mel_512(SR),
                                    exact=True))
    spec = frontend.spec_log_mel_512(SR)
    got = mirror(y, spec, frontend.num_frames(spec, y.shape[1]))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < PARITY_TOL


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_exact_tables_are_what_the_kernel_reads(family):
    """``mel_tables(exact=True)`` carries K2x's twiddle tables and mel
    schedule in the kernel's types and shapes; fast-mode tables are
    refused by the exact kernel's check."""
    spec = FAMILIES[family]()
    tables = frontend.mel_tables(spec, 'cpu', exact=True)
    mel_kernel.check_exact_tables(tables)
    plan = mel_kernel.exact_plan(spec.n_fft)
    np.testing.assert_array_equal(tables.twiddle.numpy(),
                                  mel_kernel.exact_twiddles(spec.n_fft))
    assert tables.twiddle.shape == (plan['twiddles'], 2)
    assert tables.sched_weights.shape[1] == plan['tpf']
    with pytest.raises(ValueError, match='exact kernel'):
        mel_kernel.check_exact_tables(frontend.mel_tables(spec, 'cpu'))
