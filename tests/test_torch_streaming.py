"""Port streaming server (a2m_torch/eval/streaming.py, pipeline.build_server)
against a2m/eval/streaming.py: the host helpers exactly, and every route
from features or waveforms to poses with a2m's tiny generator carried
across (seeded random parameters and batch statistics).

Tolerances: the numpy helpers are copies and agree exactly; ``decode_ulaw``
to 1e-6 (``expm1`` in two libraries).  Poses agree within 1e-4 of max|ref|:
the same f32 function through ~40 layers in another summation order, fed by
log-mels that agree to 1e-4 (direct vs radix DFT, see
tests/test_torch_frontend.py).

``a2m_torch/testdata/streaming_golden.npz`` holds a2m's output for the
committed flagship on 2 seeded streams of 10 s (T = 149), through
``stream_from_waveforms`` on the linear and on the framed mu-law wire, so
that the full-width port is held to JAX without compiling the full JAX
model: here on the CPU (the ``slow`` test regenerates the file from JAX
and holds it to it), and on the card by ``chip_smoke.py``.  ``python tests/test_torch_streaming.py`` regenerates it.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.lax import Precision

from a2m.config import GeneratorConfig as JaxConfig
from a2m.eval import streaming as jst
from a2m.models import Generator as JaxGenerator
from a2m_torch.config import GeneratorConfig
from a2m_torch.eval import streaming
from a2m_torch.models.generator import Generator
from a2m_torch.pipeline import SR, build_server
from torch_parity import max_rel, port_module, randomize, unflatten

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / 'a2m_torch' / 'testdata' / 'streaming_golden.npz'
NPZ = ROOT / 'artifacts' / 'flagship_best_gen.npz'
TINY = dict(in_channels=16, out_channels=16, joint_feat_dim=8, gat_heads=2)
TOL = 1e-4


# ---- host helpers ----------------------------------------------------------

@pytest.mark.parametrize('n,window,hop', [
    (200, 64, 32), (891, 64, 32), (149, 64, 32), (64, 64, 32), (30, 64, 32),
    (65, 64, 32), (100, 16, 5)])
def test_window_starts_blend_and_blend_matrix_equal_a2m(n, window, hop):
    starts = streaming.window_starts(n, window, hop)
    np.testing.assert_array_equal(starts, jst.window_starts(n, window, hop))
    rng = np.random.default_rng(n)
    pred = rng.standard_normal((len(starts), window, 5)).astype(np.float32)
    got = streaming.blend(pred, starts, n, window)
    np.testing.assert_array_equal(got, jst.blend(pred, starts, n, window))
    m = streaming._blend_matrix(starts, n, window)
    np.testing.assert_array_equal(m, jst._blend_matrix(starts, n, window))
    # the matrix is the blend
    np.testing.assert_allclose(m @ pred.reshape(-1, 5), got, atol=1e-5)
    feats = rng.standard_normal((n, 3)).astype(np.float32)
    w, s = streaming._stream_windows(feats, window, hop)
    jw, js = jst._stream_windows(feats, window, hop)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(s, js)


def test_ulaw_codec_equals_a2m():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4096) * 0.1,
                        [-2.0, -1.0, 0.0, 1.0, 2.0]]).astype(np.float32)
    codes = streaming.encode_ulaw(x)
    assert codes.dtype == np.uint8
    np.testing.assert_array_equal(codes, jst.encode_ulaw(x))
    every = np.arange(256, dtype=np.uint8)
    got = streaming.decode_ulaw(torch.from_numpy(every))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jst.decode_ulaw(jnp.asarray(every))),
                               atol=1e-6, rtol=0)
    assert streaming.ULAW_MU == jst.ULAW_MU


def test_pose_rate_specs_equal_a2m():
    for sr, method in ((SR, 'log_mel_512'), (16000, 'log_mel_512'),
                       (16000, 'log_mel_400'), (16000, 'vggish')):
        got = streaming._pose_rate_spec(sr, method)
        ref = jst._pose_rate_spec(sr, method)
        assert vars(got) == vars(ref)
    assert streaming._pose_rate_spec(SR).hop_length == 3072
    assert streaming._pose_rate_spec(16000, 'vggish').hop_length == 160 * 7


# ---- the tiny generator, carried across --------------------------------------

def _tiny_pair(n_mels: int, seed: int):
    rng = np.random.default_rng(seed)
    jgen = JaxGenerator(JaxConfig(**TINY), precision=Precision.HIGHEST)
    key = jax.random.PRNGKey(0)
    v = jax.jit(jgen.init)({'params': key, 'dropout': key},
                           jnp.zeros((1, 64, n_mels), jnp.float32))
    flat = randomize(v, rng)
    port = port_module(Generator(GeneratorConfig(**TINY)), flat)
    return jgen, unflatten(flat), port


@pytest.fixture(scope='module')
def tiny():
    """(a2m generator, its variables, the port's generator) on 128 mels."""
    return _tiny_pair(128, 0)


@pytest.fixture(scope='module')
def waves():
    """4 seeded streams of 6 s at 45.6 kHz: 90 pose frames, 3 windows."""
    rng = np.random.default_rng(5)
    return [(rng.standard_normal(SR * 6) * 0.1).astype(np.float32)
            for _ in range(4)]


@pytest.fixture(scope='module')
def fused_ref(tiny, waves):
    """a2m's fused output on the linear f32 wire, 2 streams."""
    jgen, v, _ = tiny
    return jst.stream_from_waveforms(jgen, v, waves[:2], SR)


def _assert_close(got, ref, tol=TOL):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == np.float32 and g.shape == r.shape
        assert max_rel(g, r) < tol, max_rel(g, r)


def test_stream_poses_long_and_short(tiny):
    jgen, v, port = tiny
    rng = np.random.default_rng(1)
    for n in (200, 30):
        feats = rng.standard_normal((n, 128)).astype(np.float32)
        got = streaming.stream_poses(port, feats, hop=32, batch_size=8)
        ref = jst.stream_poses(jgen, v, feats, hop=32, batch_size=8)
        assert got.shape == (n, 104)
        _assert_close([got], [ref])


def test_stream_poses_multi_unequal_lengths(tiny):
    jgen, v, port = tiny
    rng = np.random.default_rng(2)
    feats = [rng.standard_normal((n, 128)).astype(np.float32)
             for n in (200, 130, 64, 30)]
    got = streaming.stream_poses_multi(port, feats, hop=32, batch_size=8)
    ref = jst.stream_poses_multi(jgen, v, feats, hop=32, batch_size=8)
    assert [g.shape for g in got] == [(200, 104), (130, 104), (64, 104),
                                      (30, 104)]
    _assert_close(got, ref)
    # sharing the window batch changes nothing
    single = streaming.stream_poses(port, feats[1], hop=32, batch_size=8)
    np.testing.assert_allclose(got[1], single, atol=1e-5)


def test_stream_from_waveform_chunked_and_fused(tiny, waves, fused_ref):
    jgen, v, port = tiny
    ref = jst.stream_from_waveform(jgen, v, waves[0], SR, batch_size=8)
    got = streaming.stream_from_waveform(port, waves[0], SR, batch_size=8)
    assert got.shape == (90, 104)
    _assert_close([got], [ref])
    fused = streaming.stream_from_waveform(port, waves[0], SR, fused=True)
    _assert_close([fused], [fused_ref[0]])
    # the two routes of the port agree with each other as a2m's do
    np.testing.assert_allclose(fused, got, atol=2e-4)


def test_stream_from_waveforms_auto_is_fused(tiny, waves, fused_ref):
    _, _, port = tiny
    streaming._fused_pipeline.cache_clear()
    got = streaming.stream_from_waveforms(port, waves[:2], SR)
    assert streaming._fused_pipeline.cache_info().misses == 1
    _assert_close(got, fused_ref)
    # torch tensors are taken as well as numpy arrays, and the pipeline of
    # a (generator, length, wire format) is built once
    again = streaming.stream_from_waveforms(
        port, [torch.from_numpy(w) for w in waves[:2]], SR)
    assert streaming._fused_pipeline.cache_info().misses == 1
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)


def test_stream_from_waveforms_unequal_lengths(tiny, waves):
    jgen, v, port = tiny
    mixed = [waves[0], waves[1][:int(SR * 4.5)], waves[2]]
    got = streaming.stream_from_waveforms(port, mixed, SR, batch_size=8)
    ref = jst.stream_from_waveforms(jgen, v, mixed, SR, batch_size=8)
    assert [g.shape[0] for g in got] == [90, 67, 90]
    _assert_close(got, ref)


def test_stream_from_waveforms_int16_wire(tiny, waves):
    jgen, v, port = tiny
    w16 = [(w * 32767).astype(np.int16) for w in waves[:2]]
    got = streaming.stream_from_waveforms(port, w16, SR)
    _assert_close(got, jst.stream_from_waveforms(jgen, v, w16, SR))
    as_float = streaming.stream_from_waveforms(
        port, [w.astype(np.float32) / 32768.0 for w in w16], SR)
    for a, b in zip(got, as_float):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_stream_from_waveforms_ulaw_wire_and_pipeline_groups(tiny, waves):
    jgen, v, port = tiny
    wire = [streaming.encode_ulaw(w) for w in waves]
    got = streaming.stream_from_waveforms(port, wire, SR, encoding='ulaw')
    ref = jst.stream_from_waveforms(jgen, v, wire, SR, encoding='ulaw')
    _assert_close(got, ref)
    grouped = streaming.stream_from_waveforms(port, wire, SR,
                                              encoding='ulaw',
                                              pipeline_groups=2)
    for a, b in zip(got, grouped):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_stream_from_waveforms_framed_wires(tiny, waves, fused_ref):
    jgen, v, port = tiny
    n = len(waves[0])
    framed = streaming.frame_streams_for_wire(waves[:2], SR)
    for f, jf in zip(framed, jst.frame_streams_for_wire(waves[:2], SR)):
        np.testing.assert_array_equal(f, jf)
    assert sum(f.nbytes for f in framed) < sum(w.nbytes for w in waves[:2])
    got = streaming.stream_from_waveforms(port, framed, SR,
                                          framed_n_samples=n)
    _assert_close(got, fused_ref)
    # framed == unframed, bit for bit, as in a2m
    plain = streaming.stream_from_waveforms(port, waves[:2], SR)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)
    # framed mu-law: encode, then frame; the zero tail is code 128
    fu = streaming.frame_streams_for_wire(waves[:2], SR, encoding='ulaw')
    for f, jf in zip(fu, jst.frame_streams_for_wire(waves[:2], SR,
                                                    encoding='ulaw')):
        assert f.dtype == np.uint8
        np.testing.assert_array_equal(f, jf)
    got_u = streaming.stream_from_waveforms(port, fu, SR, encoding='ulaw',
                                            framed_n_samples=n,
                                            pipeline_groups=2)
    ref_u = jst.stream_from_waveforms(jgen, v, fu, SR, encoding='ulaw',
                                      framed_n_samples=n)
    _assert_close(got_u, ref_u)


@pytest.mark.parametrize('method', ['log_mel_400', 'vggish'])
def test_stream_400_family_on_64_mels(method):
    jgen, v, port = _tiny_pair(64, 7)
    y = (np.random.default_rng(8).standard_normal(16000 * 6) * 0.1).astype(
        np.float32)
    ref = jst.stream_from_waveform(jgen, v, y, 16000, method=method,
                                   fused=True)
    got = streaming.stream_from_waveform(port, y, 16000, method=method,
                                         fused=True)
    assert got.shape == ref.shape == (86, 104)
    _assert_close([got], [ref])
    chunked = streaming.stream_from_waveform(port, y, 16000, method=method)
    np.testing.assert_allclose(chunked, got, atol=2e-4)


def test_every_value_error_of_a2m(tiny, waves):
    jgen, v, port = tiny
    wire = [streaming.encode_ulaw(w) for w in waves]
    unequal = [waves[0], waves[1][:SR]]
    n = len(waves[0])
    framed = streaming.frame_streams_for_wire(waves[:2], SR)
    cases = [
        ('16000', lambda m, *a: m._pose_rate_spec(SR, 'log_mel_400')),
        ('unknown streaming method',
         lambda m, *a: m._pose_rate_spec(16000, 'nope')),
        ('unknown streaming method',
         lambda m, *a: m.stream_from_waveform(*a, waves[0], SR,
                                              method='nope')),
        ('ulaw wire format is uint8',
         lambda m, *a: m.stream_from_waveforms(*a, waves[:2], SR,
                                               encoding='ulaw')),
        ('unknown wire encoding',
         lambda m, *a: m.stream_from_waveforms(*a, waves[:2], SR,
                                               encoding='alaw')),
        ('unknown wire encoding',
         lambda m, *a: m.frame_streams_for_wire(waves[:2], SR,
                                                encoding='alaw')),
        ('equal-length',
         lambda m, *a: m.stream_from_waveforms(*a, unequal, SR, fused=True)),
        ('divide',
         lambda m, *a: m.stream_from_waveforms(*a, wire, SR,
                                               encoding='ulaw',
                                               pipeline_groups=3)),
        ('non-linear wire encodings',
         lambda m, *a: m.stream_from_waveforms(
             *a, [wire[0], wire[1][:SR]], SR, encoding='ulaw')),
        ('framed wire',
         lambda m, *a: m.stream_from_waveforms(*a, waves[:2], SR,
                                               framed_n_samples=n)),
        ('framed wire',
         lambda m, *a: m.stream_from_waveforms(
             *a, [framed[0], framed[1][:-1]], SR, framed_n_samples=n)),
    ]
    for match, call in cases:
        with pytest.raises(ValueError, match=match):
            call(jst, jgen, v)
        with pytest.raises(ValueError, match=match):
            call(streaming, port)


def test_framed_frame_count_is_validated(tiny, waves):
    """A frame stack whose T is not the frame count of ``framed_n_samples``
    raises, where a2m's index clamp would repeat or drop frames silently."""
    _, _, port = tiny
    n = len(waves[0])
    framed = streaming.frame_streams_for_wire(waves[:2], SR)
    assert framed[0].shape == (90, 2048)
    for wrong in (n - 3072, n + 3072):
        with pytest.raises(ValueError, match='framed wire'):
            streaming.stream_from_waveforms(port, framed, SR,
                                            framed_n_samples=wrong)
    # the pipeline itself checks too, whoever calls it
    run = streaming._fused_pipeline(port, SR, 'log_mel_512', n, 64, 32,
                                    'linear', True)
    with pytest.raises(ValueError, match='framed wire'):
        run(torch.zeros(1, 89, 2048))


def test_build_server_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip('this check is for a machine without a CUDA device')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        build_server()


# ---- the flagship against a2m's JAX output -----------------------------------

def golden_waveforms(seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(SR * 10) * 0.1).astype(np.float32)
            for _ in range(2)]


def make_golden(seed: int = 0) -> dict:
    """a2m's streamed flagship poses on the seeded streams (JAX, CPU): the
    linear wire, and the framed mu-law wire."""
    from a2m.train.checkpoint import load_best_generator_npz
    best = load_best_generator_npz(NPZ)
    variables = {'params': best['params'],
                 'batch_stats': best['batch_stats']}
    model = JaxGenerator(JaxConfig(fused_gcn=False))
    waves = golden_waveforms(seed)
    linear = jst.stream_from_waveforms(model, variables, waves, SR)
    framed = jst.frame_streams_for_wire(waves, SR, encoding='ulaw')
    ulaw = jst.stream_from_waveforms(model, variables, framed, SR,
                                     encoding='ulaw',
                                     framed_n_samples=len(waves[0]))
    return dict(seed=np.int64(seed), linear=np.stack(linear),
                framed_ulaw=np.stack(ulaw))


@pytest.fixture(scope='module')
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_golden_file_shape(golden):
    assert golden['linear'].shape == golden['framed_ulaw'].shape == (
        2, 149, 104)
    assert golden['linear'].dtype == np.float32
    assert np.isfinite(golden['linear']).all()
    # the mu-law wire is a different input: close, not equal
    assert 0 < max_rel(golden['framed_ulaw'], golden['linear']) < 0.1


@pytest.mark.slow
def test_golden_file_matches_jax(golden):
    fresh = make_golden(int(golden['seed']))
    for key in ('linear', 'framed_ulaw'):
        # XLA's CPU code may round differently on another host ISA
        np.testing.assert_allclose(fresh[key], golden[key],
                                   atol=1e-5 * np.abs(golden[key]).max())


@pytest.mark.parametrize('fused_edge,precise,tol', [
    (True, True, 1e-4), (True, False, 1e-2), (False, True, 1e-4)],
    ids=['edge_precise', 'edge_bf16', 'dense_precise'])
def test_port_server_matches_golden(golden, fused_edge, precise, tol):
    serve = build_server(device='cpu', fused_edge=fused_edge,
                         fused_precise=precise)
    waves = golden_waveforms(int(golden['seed']))
    got = np.stack(serve(waves))
    assert max_rel(got, golden['linear']) < tol
    framed = streaming.frame_streams_for_wire(waves, SR, encoding='ulaw')
    got_u = np.stack(serve(framed, encoding='ulaw',
                           framed_n_samples=len(waves[0])))
    assert max_rel(got_u, golden['framed_ulaw']) < tol


if __name__ == '__main__':
    # regenerate the golden: PYTHONPATH=.:tests python \
    #     tests/test_torch_streaming.py
    np.savez(GOLDEN, **make_golden())
