"""The port's rendering (a2m_torch/viz) against a2m's (a2m/viz), on the CPU.

Both draw with matplotlib's Agg backend, so the frames of
``save_side_by_side_video`` are equal pixel for pixel.
``generate_video.run`` on a seeded tiny generator carried across (an
a2m-written best-G ``.npz``) gives a2m's display keypoints and
``pck_mean`` within 1e-5 (relative to max|ref| for the keypoints,
absolute for the PCK).  The harness with ``render_sample_to`` returns the
video it wrote.  Both renderers call ffmpeg wherever it is on PATH; these
tests force their GIF route (``have_ffmpeg`` patched to False), so they
hold the same files on every machine.
"""

from __future__ import annotations

import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from a2m.config import Config as JaxConfig
from a2m.config import GeneratorConfig as JaxGeneratorConfig
from a2m.models import Generator as JaxGenerator
from a2m.train import checkpoint as jckpt
from a2m.viz import generate_video as jax_generate_video
from a2m.viz import render as jax_render
from a2m_torch.config import Config, GeneratorConfig
from a2m_torch.eval.harness import evaluate_speaker
from a2m_torch.viz import generate_video, render
from torch_parity import max_rel, randomize, unflatten

TINY_G = dict(in_channels=16, out_channels=16, joint_feat_dim=8, gat_heads=2)
#: display keypoints (share of max|ref|) and pck_mean (absolute)
KEYPOINT_TOL = PCK_TOL = 1e-5


@pytest.fixture(scope='module', autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    """The GIF route of both renderers, whatever the machine has."""
    for mod in (render, jax_render):
        monkeypatch.setattr(mod, 'have_ffmpeg', lambda: False)


@pytest.fixture(scope='module')
def pats_root(tmp_path_factory):
    from a2m.data import make_synthetic_pats
    return make_synthetic_pats(tmp_path_factory.mktemp('pats_viz'),
                               speakers=('oliver',),
                               intervals_per_speaker=4, duration_s=8.0)


@pytest.fixture(scope='module')
def npz(tmp_path_factory):
    """An a2m-written best-G file of a seeded random tiny generator, without
    pose statistics (both runs compute them from their loaders)."""
    model = JaxGenerator(JaxGeneratorConfig(**TINY_G))
    variables = jax.eval_shape(model.init, {'params': jax.random.PRNGKey(0),
                                            'dropout': jax.random.PRNGKey(0)},
                               np.zeros((1, 64, 128), np.float32))
    tree = unflatten(randomize(variables, np.random.default_rng(7)))
    return jckpt.save_best_generator_npz(
        dict(params=tree['params'], batch_stats=tree['batch_stats']),
        tmp_path_factory.mktemp('npz') / 'best_gen.npz')


def _keypoints(rng, n: int) -> np.ndarray:
    """n seeded (2, 52) poses on the side-by-side canvas."""
    return rng.uniform([[200.0], [100.0]], [[1300.0], [900.0]], (n, 2, 52))


def test_display_transform_matches_a2m(rng):
    pose = rng.standard_normal((5, 2, 52)) * 100
    for kw in ({}, dict(scale=2.0, flip_y=False),
               dict(scale=3.0, offset=(-1500.0, 0.0))):
        np.testing.assert_array_equal(render.display_transform(pose, **kw),
                                      jax_render.display_transform(pose,
                                                                   **kw))


def test_side_by_side_frames_equal_a2ms(rng, tmp_path):
    """Two predicted frames beside ground truth, with one conditioning
    frame drawn alone first: the same JPEGs pixel for pixel, and the GIF
    of the frames."""
    pred, real = _keypoints(rng, 2), _keypoints(rng, 3)
    frames = {}
    for name, mod in (('port', render), ('a2m', jax_render)):
        tmp = tmp_path / name / 'frames'
        mod.save_side_by_side_video(str(tmp), pred, real,
                                    str(tmp_path / name / 'v.mp4'),
                                    delete_tmp=False)
        frames[name] = sorted(tmp.glob('*.jpg'))
    assert [f.name for f in frames['port']] == ['0000.jpg', '0001.jpg',
                                                '0002.jpg']
    assert [f.name for f in frames['a2m']] == [f.name for f in frames['port']]
    for a, b in zip(frames['port'], frames['a2m']):
        np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                      np.asarray(Image.open(b)))
    for name in ('port', 'a2m'):
        assert (tmp_path / name / 'v.gif').is_file()


def test_generate_video_matches_a2m(pats_root, npz, tmp_path, monkeypatch):
    """``run`` gives a2m's display keypoints and pck_mean; what it draws
    is held by the test above, so both drawings are captured here."""
    drawn = {}
    for name, mod in (('port', render), ('a2m', jax_render)):
        def capture(folder, k1, k2, out, delete_tmp=True, name=name):
            drawn[name] = (np.asarray(k1), np.asarray(k2))
        monkeypatch.setattr(mod, 'save_side_by_side_video', capture)
    got = generate_video.run(pats_root, 'oliver', npz, tmp_path / 'port',
                             batch_size=8, device='cpu',
                             cfg=Config(generator=GeneratorConfig(**TINY_G)))
    want = jax_generate_video.run(
        pats_root, 'oliver', npz, tmp_path / 'a2m', batch_size=8,
        cfg=JaxConfig(generator=JaxGeneratorConfig(**TINY_G)))
    assert abs(got['pck_mean'] - want['pck_mean']) <= PCK_TOL
    assert 0.0 < want['pck_mean'] < 1.0
    for g, w in zip(drawn['port'], drawn['a2m']):
        assert g.shape == w.shape == (64, 2, 52)
        assert max_rel(g, w) <= KEYPOINT_TOL, max_rel(g, w)
    # a2m names the .mp4 also when it wrote a GIF; the port the file written
    assert want['video'].endswith('oliver_sample1.mp4')
    assert got['video'] == str(tmp_path / 'port' / 'oliver_sample1.gif')


def test_harness_renders_a_sample_video(pats_root, npz, tmp_path,
                                       monkeypatch):
    """``render_sample_to`` writes the sample video and returns it.  Its
    64 side-by-side frames are drawn at a tenth of the resolution (dpi
    20): what a frame holds is the pixel test's above."""
    monkeypatch.setattr(render, 'draw_side_by_side_poses', functools.partial(
        render.draw_side_by_side_poses, dpi=20))
    res = evaluate_speaker(pats_root, 'oliver', npz, batch_size=8,
                           cfg=Config(generator=GeneratorConfig(**TINY_G)),
                           device='cpu', render_sample_to=tmp_path / 'v')
    video = Path(res['video'])
    assert video == tmp_path / 'v' / 'oliver_sample1.gif'
    with Image.open(video) as gif:
        assert gif.n_frames == 64
    assert not (tmp_path / 'v' / 'tmp_frames').exists()
    assert res['n_clips'] > 0 and np.isfinite(res['l2'])
