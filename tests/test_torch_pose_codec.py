"""The port's pose codec, silence mask and dataset diagnosis against a2m's,
on the CPU.

``a2m_torch/data/pose_codec.py`` and ``a2m/data/pose_codec.py`` are both
numpy: on the same inputs every function and ``SpeakerStats`` give equal
arrays, bit for bit, and the legacy asset is the same bytes.
``frontend.silence_mask`` (torch, on the tensor's device) gives a2m's
int32 stream exactly on seeded waveforms with silent stretches.
``diagnose`` walks a ``make_synthetic_pats`` tree as a2m's does, with the
same failures and log lines.
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a2m.audio import frontend as jax_frontend
from a2m.data import pose_codec as jpc
from a2m.data.diagnose import diagnose as jax_diagnose
from a2m_torch.audio import frontend
from a2m_torch.data import pose_codec as tpc
from a2m_torch.data.diagnose import diagnose

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def pats_root(tmp_path_factory):
    from a2m.data import make_synthetic_pats
    return make_synthetic_pats(tmp_path_factory.mktemp('pats_codec'),
                               speakers=('oliver', 'noah'),
                               intervals_per_speaker=4, duration_s=8.0)


@pytest.fixture(scope='module')
def batches(pats_root):
    """One speaker's train batches as a list of dicts, the input both
    packages read."""
    from a2m_torch.data import DataLoader
    dl = DataLoader(path2data=pats_root, speaker=['oliver'], batch_size=8,
                    window_hop=5, shuffle=False, device='cpu')
    return {'oliver': list(dl.train)}


def test_legacy_asset_is_a2ms_bytes():
    ours = ROOT / 'a2m_torch' / 'data' / 'assets' / 'legacy_speaker_stats.json'
    theirs = ROOT / 'a2m' / 'data' / 'assets' / 'legacy_speaker_stats.json'
    assert ours.read_bytes() == theirs.read_bytes()
    assert tpc.SpeakerStats.load_legacy().stats == \
        jpc.SpeakerStats.load_legacy().stats


@pytest.mark.parametrize('reference', [None, 'oliver'])
def test_speaker_stats_compute_matches_a2m(batches, reference, tmp_path):
    two = dict(batches, noah=batches['oliver'][:1])
    got = tpc.SpeakerStats.compute(two, reference_speaker=reference)
    want = jpc.SpeakerStats.compute(two, reference_speaker=reference)
    assert got.stats == want.stats
    got.save(tmp_path / 's.json')
    assert tpc.SpeakerStats.load(tmp_path / 's.json').stats == want.stats
    for sp in two:
        for fn in ('mean', 'std', 'median'):
            np.testing.assert_array_equal(getattr(got, fn)(sp),
                                          getattr(want, fn)(sp))
        assert got.scale_factor(sp) == want.scale_factor(sp)


@pytest.mark.parametrize('num_keypoints', [52, 49])
def test_codec_functions_match_a2m(num_keypoints, rng):
    """Every function on the same inputs: 52 joints with stats computed
    from seeded poses, 49 with the legacy asset."""
    n = 2 * num_keypoints
    k = rng.standard_normal((6, n)) * 50 + 300
    if num_keypoints == 52:
        stats = {'s': dict(mean=list(rng.standard_normal(n)),
                           std=list(rng.uniform(0.5, 2.0, n)),
                           median=list(rng.standard_normal(n)),
                           scale_factor=1.3)}
        t_stats, j_stats, sp = (tpc.SpeakerStats(stats),
                                jpc.SpeakerStats(stats), 's')
    else:
        t_stats, j_stats, sp = (tpc.SpeakerStats.load_legacy(),
                                jpc.SpeakerStats.load_legacy(), 'jon')
    shift = rng.standard_normal(2)
    for got, want in (
            (tpc.preprocess_to_relative(k, num_keypoints=num_keypoints),
             jpc.preprocess_to_relative(k, num_keypoints=num_keypoints)),
            (tpc.preprocess_to_relative(k, False, num_keypoints),
             jpc.preprocess_to_relative(k, False, num_keypoints)),
            (tpc.normalize_relative_keypoints(k, sp, t_stats),
             jpc.normalize_relative_keypoints(k, sp, j_stats)),
            (tpc.de_normalize_relative_keypoints(k, sp, t_stats),
             jpc.de_normalize_relative_keypoints(k, sp, j_stats)),
            (tpc.de_normalize_relative_keypoints(k, sp, t_stats, True),
             jpc.de_normalize_relative_keypoints(k, sp, j_stats, True)),
            (tpc.translate_keypoints(k.reshape(-1, 2, num_keypoints), shift),
             jpc.translate_keypoints(k.reshape(-1, 2, num_keypoints), shift)),
            (tpc.decode_pose_normalized_keypoints(
                k, shift, sp, t_stats, num_keypoints=num_keypoints),
             jpc.decode_pose_normalized_keypoints(
                 k, shift, sp, j_stats, num_keypoints=num_keypoints)),
            (tpc.decode_pose_normalized_keypoints(
                k, shift, sp, t_stats, False, num_keypoints),
             jpc.decode_pose_normalized_keypoints(
                 k, shift, sp, j_stats, False, num_keypoints)),
            (tpc.delete_face_keypoints(k.reshape(-1, 2, num_keypoints), 2),
             jpc.delete_face_keypoints(k.reshape(-1, 2, num_keypoints), 2)),
            (tpc.get_sample_output_by_config(k[None], 0.5),
             jpc.get_sample_output_by_config(k[None], 0.5)),
            (tpc.get_sample_output_by_config(k, None),
             jpc.get_sample_output_by_config(k, None))):
        np.testing.assert_array_equal(got, want)
    assert tpc.conditioned_timesteps(0.3, 64) == \
        jpc.conditioned_timesteps(0.3, 64)
    # a torch tensor goes through the relative encoding unchanged
    np.testing.assert_array_equal(
        tpc.preprocess_to_relative(torch.from_numpy(k),
                                   num_keypoints=num_keypoints).numpy(),
        jpc.preprocess_to_relative(k, num_keypoints=num_keypoints))


def _speech_with_silences(rng, n: int) -> np.ndarray:
    """Seeded noise bursts at random levels with silent stretches."""
    y = rng.standard_normal(n) * rng.uniform(0.01, 0.5)
    edges = np.sort(rng.integers(0, n, 8))
    for a, b in zip(edges[::2], edges[1::2]):
        y[a:b] *= 1e-4                      # -80 dB: silent
    level = np.repeat(rng.uniform(0.02, 1.0, n // 1600 + 1), 1600)[:n]
    return (y * level).astype(np.float32)


@pytest.mark.parametrize('shape,fs_new', [((48000,), 15), ((3, 40000), 15),
                                          ((2, 33333), 30)])
def test_silence_mask_matches_a2m(shape, fs_new, rng):
    y = np.stack([_speech_with_silences(rng, shape[-1])
                  for _ in range(int(np.prod(shape[:-1])))]).reshape(shape)
    want = np.asarray(jax_frontend.silence_mask(jnp.asarray(y),
                                                fs_new=fs_new))
    got = frontend.silence_mask(torch.from_numpy(y), fs_new=fs_new)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want[..., ::2] == 1).mean() < 1   # both decisions occur


def test_diagnose_matches_a2m(pats_root):
    """The same walk and log lines on a clean tree; a malformed batch from
    an in-memory loader is trapped and reported."""
    got_log, want_log = [], []
    got = diagnose(pats_root, ['oliver', 'noah'], log=got_log.append,
                   device='cpu')
    want = jax_diagnose(pats_root, ['oliver', 'noah'], log=want_log.append)
    assert got == want == []
    assert got_log == want_log
    bad = SimpleNamespace(train=[
        {'pose/data': np.zeros((4, 64, 104), np.float32),
         'audio/log_mel_512': np.zeros((4, 64), np.float32),
         'meta': 'interval 7'}])
    lines = []
    failures = diagnose(None, ['oliver'], log=lines.append, loader=bad)
    assert [f['batch'] for f in failures] == [0]
    assert failures[0]['meta'] == 'interval 7'
    assert 'audio/log_mel_512 has ndim 2' in failures[0]['error']
    assert lines[-1] == 'diagnosis complete: 1 failing batches'
