"""The WavLM speech tower in front of the generator (a2m_torch/nn/wavlm.py,
nn/rel_attention.py, the tower routes of eval/streaming.py and pipeline.py)
against the benchmark's plain reference (benchmark/reference/wavlm_gen.py,
loaded by its path), and that reference against ``transformers``'
``WavLMModel``, on the CPU at a small size: d = 64, 2 layers, 4 heads, a
32-channel extractor, a positional convolution of 16 taps in 4 groups, the
published 320 buckets and distance 800.  The window stage is the committed
flagship's.  No full-width tower is built here but on ``meta``.

Tolerances: the reference equals ``WavLMModel`` up to f32 summation order
(2e-5 of the largest magnitude).  The port rounds every product's operands
(and results) to bf16 where the reference stays f32: about 1% of the
hidden state's RMS here, held under 3e-2; the poses under 3e-2 of theirs.
Each planted control (the gated bias left out; fp8 e4m3 operands) must read
above three times the sound gap and above the benchmark cell's limit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from a2m_torch import pipeline
from a2m_torch.config import (WAVLM_LARGE, Config, GeneratorConfig,
                              TowerConfig, validate, validate_tower)
from a2m_torch.eval import streaming
from a2m_torch.nn import rel_attention as k6
from a2m_torch.nn import wavlm

ROOT = Path(__file__).resolve().parents[1]
CELL = ROOT / 'benchmark' / 'workloads' / 'wavlm_stream_8x60.json'
SMALL = TowerConfig(hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
                    num_conv_pos_embedding_groups=4)
SEED = 2718281828459
SR = 16000


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _load('wavlm_gen_reference',
            ROOT / 'benchmark' / 'reference' / 'wavlm_gen.py')
TOWER = {k: list(v) if isinstance(v, tuple) else v
         for k, v in dataclasses.asdict(SMALL).items()}


def _rms_gap(got, want) -> float:
    got, want = (torch.as_tensor(np.asarray(x), dtype=torch.float64)
                 for x in (got, want))
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean()
                 .sqrt())


def _waves(*seconds, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    t = np.arange(int(max(seconds) * SR)) / SR
    out = []
    for s in seconds:
        f0 = rng.uniform(90, 260)
        voice = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6)) / h
                    for h in range(1, 5))
        env = (0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 6) * t)) ** 2
        y = env * voice + 0.05 * rng.standard_normal(t.size)
        out.append((0.5 * y / np.abs(y).max())[:int(s * SR)]
                   .astype(np.float32))
    return out


@pytest.fixture(scope='module')
def port_gen():
    config = GeneratorConfig(fused_gcn=True, fused_edge=True, tower=SMALL)
    return pipeline.load_generator(None, config, 'cpu', SEED)


@pytest.fixture(scope='module')
def ref_models():
    gen = ref.motion.Generator(json.loads(
        (ROOT / 'benchmark' / 'configs' / 'wavlm_large_gen.json')
        .read_text())['generator'])
    flat, _ = ref.motion.load_npz(pipeline.FLAGSHIP_NPZ)
    gen.load_state_dict(ref.motion.state_from_flat(flat, gen))
    tower = ref.Tower(TOWER, ref.seeded_state(TOWER, SEED, 'cpu'))
    return gen.eval(), tower


# -- the port against the reference ------------------------------------------

@pytest.mark.parametrize('seconds', [(5.0, 5.0), (5.0, 6.1)],
                         ids=['equal', 'unequal'])
def test_served_poses_match_the_reference(port_gen, ref_models, seconds,
                                          monkeypatch):
    gen, tower = ref_models
    gen.set_stack_mode('edge')
    waves = _waves(*seconds)
    hidden_states = []                  # each length group's, in order
    encode = port_gen.tower.encode
    monkeypatch.setattr(port_gen.tower, 'encode', lambda w: (
        hidden_states.append(encode(w)) or hidden_states[-1]))
    got = streaming.stream_from_waveforms(port_gen, waves, SR)
    for wave, poses in zip(waves, got):
        n_frames = len(wave) * 15 // SR
        assert poses.shape == (n_frames, 104)
        want = ref.stream_poses(gen, tower, torch.from_numpy(wave))
        assert _rms_gap(poses, want) < 3e-2
    hidden = tower.hidden(torch.from_numpy(waves[-1]))
    assert _rms_gap(hidden_states[-1][-1], hidden) < 3e-2


def test_window_poses_match_the_reference(port_gen, ref_models):
    gen, tower = ref_models
    gen.set_stack_mode('dense')
    waves = np.stack(_waves(4.3, 4.3, 4.3, seed=1))
    dense = pipeline.load_generator(
        None, GeneratorConfig(fused_gcn=True, tower=SMALL), 'cpu', SEED)
    got = pipeline.audio_to_pose_fn(dense, 'cpu')(waves)
    assert got.shape == (3, 64, 104)
    for wave, poses in zip(waves, got):
        feats = tower.features(torch.from_numpy(wave))
        want = ref.window_stage(gen, feats[None])[0]
        assert _rms_gap(poses, want) < 3e-2


def test_the_entry_points_take_a_tower_on_the_cpu():
    serve = pipeline.build_server(device='cpu', tower=SMALL, tower_seed=3)
    poses = serve(_waves(4.5, 4.5, seed=2))
    assert [p.shape for p in poses] == [(67, 104), (67, 104)]
    with pytest.raises(ValueError, match='16000 Hz'):
        serve(_waves(4.5), sr=pipeline.SR)
    audio_to_pose = pipeline.build_pipeline(device='cpu', batch=2,
                                            tower=SMALL)
    assert audio_to_pose(np.stack(_waves(4.3, 4.3))).shape == (2, 64, 104)


def test_seeded_draws_of_program_and_reference_are_equal():
    mine = wavlm.seeded_state(SMALL, SEED, 'cpu', 256)
    theirs = ref.seeded_state(TOWER, SEED, 'cpu', 256)
    assert list(mine) == list(theirs)
    assert all(torch.equal(mine[k], theirs[k]) for k in mine)


# -- the reference against transformers ---------------------------------------

def test_reference_matches_transformers_wavlm():
    transformers = pytest.importorskip('transformers')
    cfg = transformers.WavLMConfig(
        **{k: v for k, v in TOWER.items() if k != 'sample_rate'},
        feat_extract_norm='layer', do_stable_layer_norm=True)
    model = transformers.WavLMModel(cfg).eval()
    state = {k: v for k, v in ref.seeded_state(TOWER, 11, 'cpu').items()
             if not k.startswith('join.')}
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert missing == ['masked_spec_embed'] and not unexpected
    wave = torch.from_numpy(_waves(3.0, seed=4)[0])
    x = (wave - wave.mean()) / torch.sqrt(wave.var(unbiased=False) + 1e-7)
    with torch.no_grad():
        want = model(x[None]).last_hidden_state[0]
    got = ref.Tower(TOWER, ref.seeded_state(TOWER, 11, 'cpu')).hidden(wave)
    assert got.shape == want.shape == (149, 64)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=2e-5 * float(want.abs().max()))


@pytest.mark.parametrize('side', ['program', 'reference'])
def test_buckets_equal_transformers_for_every_offset(side):
    rel = torch.arange(-2999, 3000)
    fn = wavlm.relative_buckets if side == 'program' else ref.bucket
    got = fn(rel, 320, 800)
    assert int(got.min()) == 0 and int(got.max()) == 319
    transformers = pytest.importorskip('transformers')
    attn = transformers.models.wavlm.modeling_wavlm.WavLMAttention(
        64, 4, num_buckets=320, max_distance=800)
    assert torch.equal(got, attn._relative_positions_bucket(rel))


# -- K6's plain version -------------------------------------------------------

def test_k6_plain_path_equals_the_written_out_bias():
    gen = torch.Generator().manual_seed(0)
    b, t, h, d = 2, 37, 3, 16
    q, k, v = (torch.randn(b, t, h, d, generator=gen).bfloat16()
               for _ in range(3))
    gates = 1.5 + 1.5 * torch.rand(b, t, h, generator=gen)    # away from 1
    table = torch.randn(h, 2 * t - 1, generator=gen)
    got = k6.rel_attention(q, k, v, gates, table, 0.25)
    want = torch.empty(b, t, h, d)
    for bi in range(b):
        for hi in range(h):
            s = q[bi, :, hi].float() @ k[bi, :, hi].float().t() * 0.25
            for ti in range(t):
                s[ti] += gates[bi, ti, hi] * table[hi, t - 1 - ti:2 * t - 1
                                                   - ti]
            want[bi, :, hi] = torch.softmax(s, -1) @ v[bi, :, hi].float()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert k6.rel_attention.launches == 0          # no launch on the CPU
    with pytest.raises(ValueError, match='table'):
        k6.rel_attention(q, k, v, gates, table[:, 1:], 0.25)


def test_flat_distance_is_the_least_saturated_offset():
    gen = torch.Generator().manual_seed(0)
    t = 30
    rel = torch.arange(-(t - 1), t)

    def flat_at(row, d):
        return bool((row[rel <= -d] == row[0]).all()
                    and (row[rel >= d] == row[-1]).all())

    for _ in range(200):
        row = torch.randint(0, 3, (2 * t - 1,), generator=gen)
        a, b = torch.randint(0, t, (2,), generator=gen).tolist()
        row[:a], row[2 * t - 1 - b:] = row[0], row[-1]
        d = k6.flat_distance(row)
        assert flat_at(row, d) and (d == 1 or not flat_at(row, d - 1))
    row = wavlm.relative_buckets(torch.arange(-2998, 2999), 320, 800)
    assert k6.flat_distance(row) == 778


def _k6_tiled(q, k, v, gates, table, scale, flat):
    """K6's algorithm as ``csrc/rel_attention.cu`` runs it, in plain torch:
    blocks of 128 queries over key steps of 64, each step's table values
    copied as a segment, steps beyond ``flat`` on the table's end value,
    the online softmax in base 2, P rounded to bf16 for its product.
    Returns the output and the number of (block, step) pairs on the end
    values."""
    bm, bn, log2e = 128, 64, 1.4426950408889634
    b, t, h, d = q.shape
    out = torch.empty(b, t, h, d)
    r, c = torch.arange(bm), torch.arange(bn)
    flat_steps = 0

    def padded(x, lo, n):
        return torch.cat([x[lo:lo + n].float(),
                          torch.zeros(max(0, lo + n - t), *x.shape[1:])])

    for bi in range(b):
        for hi in range(h):
            tab = table[hi].float()
            for m0 in range(0, t, bm):
                qb = padded(q[bi, :, hi], m0, bm)
                g = padded(gates[bi, :, hi], m0, bm) * log2e
                m = torch.full((bm,), -torch.inf)
                l, acc = torch.zeros(bm), torch.zeros(bm, d)
                for n0 in range(0, t, bn):
                    kb, vb = (padded(x[bi, :, hi], n0, bn) for x in (k, v))
                    at = n0 - m0 - (bm - 1) + torch.arange(bm + bn - 1) \
                        + t - 1
                    ok = (at >= 0) & (at < 2 * t - 1)
                    seg = torch.where(ok, tab[at.clamp(0, 2 * t - 2)], 0.0)
                    if n0 + bn - 1 - m0 <= -flat:
                        e, flat_steps = tab[0], flat_steps + 1
                    elif n0 - m0 - (bm - 1) >= flat:
                        e, flat_steps = tab[-1], flat_steps + 1
                    else:
                        e = seg[c[None, :] - r[:, None] + bm - 1]
                    s = qb @ kb.t() * (scale * log2e) + g[:, None] * e
                    s[:, n0 + c >= t] = -torch.inf
                    mn = torch.maximum(m, s.max(1).values)
                    alpha, p = torch.exp2(m - mn), torch.exp2(s - mn[:, None])
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] \
                        + p.bfloat16().float() @ vb.bfloat16().float()
                    m = mn
                n = min(bm, t - m0)
                out[bi, m0:m0 + n, hi] = (acc / l[:, None])[:n]
    return out, flat_steps


def test_k6_tiling_matches_its_plain_version():
    gen = torch.Generator().manual_seed(3)
    b, t, h, d = 1, 200, 2, 16          # T a multiple of neither tile
    q, k, v = (torch.randn(b, t, h, d, generator=gen).bfloat16()
               for _ in range(3))
    gates = 1 + 1.5 * torch.rand(b, t, h, generator=gen)
    # buckets that saturate well inside T, so that steps lie beyond them
    row = wavlm.relative_buckets(torch.arange(-(t - 1), t), 32, 40)
    table = 2 * torch.randn(32, h, generator=gen)[row].t().contiguous()
    flat = k6.flat_distance(row)
    assert flat < 64
    want = k6.rel_attention_plain(q, k, v, gates, table, 0.25)
    got, flat_steps = _k6_tiled(q, k, v, gates, table, 0.25, flat)
    every, none = _k6_tiled(q, k, v, gates, table, 0.25, t)
    assert flat_steps > 0 and none == 0
    assert torch.equal(got, every)      # the end value is the segment's
    assert _rms_gap(got, want) < 4e-3   # P in bf16: ~2^-9 a weight
    assert float((got - want).abs().max()) < 1e-2 * float(want.abs().max())


@pytest.mark.chip
def test_k6_on_the_card_matches_its_plain_version():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: K6 is a CUDA kernel')
    gen = torch.Generator(device='cuda').manual_seed(1)
    for b, t in ((1, 2999), (2, 1000)):
        q, k, v = (torch.randn(b, t, 16, 64, generator=gen, device='cuda')
                   .bfloat16() for _ in range(3))
        gates = 1 + 1.5 * torch.rand(b, t, 16, generator=gen, device='cuda')
        # WavLM's table: the bucket embedding at each offset, saturated
        row = wavlm.relative_buckets(torch.arange(-(t - 1), t), 320, 800)
        embed = torch.randn(320, 16, generator=gen, device='cuda')
        table = embed[row.cuda()].t().contiguous()
        before = k6.rel_attention.launches
        got = k6.rel_attention(q, k, v, gates, table, 0.125,
                               k6.flat_distance(row))
        assert k6.rel_attention.launches == before + 1
        want = k6.rel_attention_plain(q, k, v, gates, table, 0.125)
        # P rounded to bf16 before its product: ~2^-9 of each weight
        assert float((got - want).abs().max()) < 2e-2 * float(
            want.abs().max())
        assert _rms_gap(got.cpu(), want.cpu()) < 5e-3


# -- the published configuration ----------------------------------------------

def test_published_widths_count_wavlm_larges_parameters():
    assert wavlm.hf_num_params(WAVLM_LARGE) == 315_453_120
    with torch.device('meta'):
        tower = wavlm.SpeechTower(WAVLM_LARGE, 256)
    held = sum(p.numel() for p in tower.parameters())
    # weight norm folded (its 128 gains), no masked_spec_embed, the join
    assert held == 315_453_120 - 1024 - 128 + 1024 * 256 + 256
    transformers = pytest.importorskip('transformers')
    cfg = transformers.WavLMConfig(
        **{k: v for k, v in dataclasses.asdict(WAVLM_LARGE).items()
           if k != 'sample_rate'},
        feat_extract_norm='layer', do_stable_layer_norm=True)
    with torch.device('meta'):
        model = transformers.WavLMModel(cfg)
    assert sum(p.numel() for p in model.parameters()) == 315_453_120


def test_the_benchmark_config_holds_the_published_tower():
    cfg = json.loads((ROOT / 'benchmark' / 'configs' /
                      'wavlm_large_gen.json').read_text())
    held = dataclasses.asdict(WAVLM_LARGE)
    assert {k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg['tower'].items()} == held
    assert cfg['reduced'] == []


def test_validate_refuses_a_tower_that_does_not_fit():
    assert validate_tower(SMALL) is SMALL
    for bad in (dataclasses.replace(SMALL, num_attention_heads=5),
                dataclasses.replace(SMALL, conv_kernel=(10, 3)),
                dataclasses.replace(SMALL, num_buckets=30),
                dataclasses.replace(SMALL, num_conv_pos_embedding_groups=3)):
        with pytest.raises(ValueError, match='tower'):
            validate(Config(generator=GeneratorConfig(tower=bad)))
        with pytest.raises(ValueError, match='tower'):
            wavlm.SpeechTower(bad)


def test_frame_counts_come_from_the_audio_stage(port_gen):
    assert streaming._audio_frames(port_gen, SR, 'log_mel_512',
                                   960000) == 900
    assert port_gen.tower.num_frames(68800) == 64
    flagship = pipeline.load_generator(None, GeneratorConfig(), 'cpu')
    spec = streaming._pose_rate_spec(pipeline.SR)
    assert streaming._audio_frames(flagship, pipeline.SR, 'log_mel_512',
                                   2736000) == 891 == \
        streaming.frontend.num_frames(spec, 2736000)


# -- the limits' controls, planted --------------------------------------------

def _drop_bias(monkeypatch):
    real = wavlm.rel_attention
    monkeypatch.setattr(wavlm, 'rel_attention',
                        lambda q, k, v, g, *rest:
                        real(q, k, v, torch.zeros_like(g), *rest))


def _fp8_operands(monkeypatch):
    monkeypatch.setattr(wavlm.SpeechTower, 'operand', lambda self, x: x.to(
        torch.float8_e4m3fn).to(torch.bfloat16))


@pytest.mark.parametrize('plant', [_drop_bias, _fp8_operands],
                         ids=['bias-dropped', 'fp8-operands'])
def test_each_planted_control_is_caught(ref_models, monkeypatch, plant):
    limit = json.loads(CELL.read_text())['limits']['feat_gap']
    _, tower = ref_models
    wave = torch.from_numpy(_waves(5.0, seed=3)[0])
    want = tower.hidden(wave)
    port = wavlm.SpeechTower(SMALL, 256)
    port.load_hf_state(wavlm.seeded_state(SMALL, SEED, 'cpu', 256))
    with torch.no_grad():
        sound = _rms_gap(port.encode(wave[None])[0], want)
        plant(monkeypatch)
        port._operands.clear()
        planted = _rms_gap(port.encode(wave[None])[0], want)
    assert sound < limit < planted and planted > 3 * sound


# -- spans --------------------------------------------------------------------

@pytest.mark.parametrize('seconds,kw,groups', [
    ((4.5, 4.5, 5.0), {}, 2), ((4.5, 4.5), {'pipeline_groups': 2}, 2),
    ((4.5, 4.5), {}, 1)], ids=['chunked', 'fused-2-groups', 'fused'])
def test_a_traced_tower_call_records_its_span_once_per_group(
        port_gen, seconds, kw, groups):
    from torch.profiler import ProfilerActivity, profile
    waves = _waves(*seconds, seed=5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        streaming.stream_from_waveforms(port_gen, waves, SR, **kw)
    names = [e.name for e in prof.events()]
    assert names.count('a2m.serve.tower') == groups
    assert names.count('a2m.serve') == 1


def test_step_flops_adds_k6_launches_to_the_counted_tower(port_gen,
                                                          monkeypatch):
    from a2m_torch.utils import mfu
    waves = torch.from_numpy(np.stack(_waves(2.0, 2.0, seed=6)))
    tower = port_gen.tower
    _, plain = mfu.step_flops(tower, waves)
    t = tower.encode(waves).shape[1]
    # on the CPU the counter sees the plain attention's QK^T and PV
    qk_pv = SMALL.num_hidden_layers * k6.rel_attention_flops(
        2, SMALL.num_attention_heads, t,
        SMALL.hidden_size // SMALL.num_attention_heads)
    assert plain > qk_pv
    real = wavlm.rel_attention

    def launch(q, k, v, gates, table, scale, flat=None):
        # what a launch on the card adds: the kernel's own count, which
        # FlopCounterMode does not see
        k6.rel_attention.flops += k6.rel_attention_flops(
            q.shape[0], q.shape[2], q.shape[1], q.shape[3])
        return real(q, k, v, gates, table, scale, flat)

    monkeypatch.setattr(wavlm, 'rel_attention', launch)
    monkeypatch.setattr(k6.rel_attention, 'flops', 0)
    _, counted = mfu.step_flops(tower, waves)
    assert counted == plain + qk_pv
