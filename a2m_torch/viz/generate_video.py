"""Inference CLI: checkpoint -> generated poses -> side-by-side video.

The port's own copy of ``a2m/viz/generate_video.py``.  Capability parity
with `generate_motion_video.py:220-290`: load a generator checkpoint, take
the first test batch, neck-sub-normalize ground truth, generate poses from
audio on the card, denormalize, apply the display transform, render
prediction/ground-truth side-by-side video (+ optional audio mux).

Usage:
    python -m a2m_torch.viz.generate_video --path2data ./pats/data \\
        --speaker oliver --ckpt ./save/multi_speaker/ckpt --out ./videos \\
        [--device cpu]

On CUDA the generator's GCN stacks run the fused forward kernel, as in
``eval/harness.py``.  Reading PATS h5 files needs ``h5py`` and ``pandas``;
``loader`` (an object with ``.train`` and ``.test``) takes their place.
Drawing needs matplotlib and PIL (:mod:`a2m_torch.viz.render`);
:func:`sample_keypoints` is the part of :func:`run` before the drawing.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

from a2m_torch.config import Config
from a2m_torch.data.normalization import get_mean_std_necksub, neck_subtract
from a2m_torch.device import resolve_device
from a2m_torch.eval.metrics import compute_pck_np, pose_blocks_to_keypoints
from a2m_torch.viz import render


def generate_poses(generator, variables, audio: np.ndarray,
                   mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """G(audio) in eval mode on the generator's device, denormalized on
    the host (generate_motion_video.py:257-260).  ``variables``: a
    ``state_dict`` to load first, or None for the module's own."""
    if variables is not None:
        generator.load_state_dict(variables)
    device = next(generator.parameters()).device
    with torch.inference_mode():
        pose_norm = generator.eval()(torch.as_tensor(
            np.asarray(audio), dtype=torch.float32).to(device))
    return pose_norm.cpu().numpy() * std + mean


def sample_keypoints(path2data, speaker: str, ckpt_dir,
                     sample_idx: int = 1, batch_size: int = 256,
                     cfg: Config | None = None, device='cuda',
                     loader=None) -> dict:
    """The poses :func:`run` draws: ``gen`` and ``real`` (B, T, 104) of the
    first test batch, the display keypoints ``gp_disp`` and ``rp_disp``
    (T, 2, 52) of row ``sample_idx``, and ``pck_mean`` over the batch."""
    from a2m_torch.models.generator import Generator
    from a2m_torch.train.checkpoint import load_any_generator_ckpt
    from a2m_torch.weights import from_jax_variables

    cfg = cfg or Config()
    dev = resolve_device(device)
    if loader is None:
        from a2m_torch.data.dataset import DataLoader
        loader = DataLoader(path2data=path2data, speaker=[speaker],
                            modalities=['pose/data', 'audio/log_mel_512'],
                            fs_new=[15, 15], batch_size=batch_size,
                            window_hop=5, device=str(dev))
    batch = next(iter(loader.test))

    g_cfg = cfg.generator
    if dev.type == 'cuda':
        g_cfg = dataclasses.replace(g_cfg, fused_gcn=True, fused_edge=False)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        generator = Generator(g_cfg)
    mean = std = None
    if ckpt_dir is not None:
        best = load_any_generator_ckpt(ckpt_dir)
        if best is not None:
            generator.load_state_dict(from_jax_variables(best['variables'],
                                                         generator))
            # prefer the training-time stats shipped with the checkpoint
            # (the reference recomputes from whatever loader it builds —
            # generate_motion_video.py:240-243 — wrong for multi-speaker
            # checkpoints evaluated per-speaker)
            if 'mean' in best:
                mean, std = best['mean'], best['std']
    if mean is None:
        mean, std = get_mean_std_necksub(loader.train)

    audio = batch['audio/log_mel_512']
    real = neck_subtract(batch['pose/data'])
    gen = generate_poses(generator.to(dev), None, audio, mean, std)

    rp = pose_blocks_to_keypoints(real)[sample_idx]     # (T, 2, 52)
    gp = pose_blocks_to_keypoints(gen)[sample_idx]

    # display transform (generate_motion_video.py:280-284): 3x scale, y-flip;
    # GT shifted right for the side-by-side canvas
    gp_disp = -render.display_transform(gp, scale=3.0)
    rp_disp = -render.display_transform(rp, scale=3.0, offset=(-1500.0, 0.0))
    pck = compute_pck_np(_flatten_bt(gen), _flatten_bt(real))
    return dict(gen=gen, real=real, gp_disp=gp_disp, rp_disp=rp_disp,
                pck_mean=float(pck.mean()))


def run(path2data, speaker: str, ckpt_dir, out_dir, sample_idx: int = 1,
        batch_size: int = 256, cfg: Config | None = None,
        audio_path: str | None = None, device='cuda', loader=None) -> dict:
    """Render row ``sample_idx`` of the first test batch, prediction beside
    ground truth, into ``out_dir/<speaker>_sample<i>.mp4`` (a ``.gif`` of
    that name without ffmpeg).  ``ckpt_dir``: a packed best-G ``.npz`` or a
    directory holding ``best_gen.npz``; None keeps the port's own seeded
    initialisation.  Returns ``video``, the file written (a2m names the
    ``.mp4`` also when it wrote the ``.gif``), and ``pck_mean``."""
    s = sample_keypoints(path2data, speaker, ckpt_dir, sample_idx=sample_idx,
                         batch_size=batch_size, cfg=cfg, device=device,
                         loader=loader)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    video_fn = str(out_dir / f'{speaker}_sample{sample_idx}.mp4')
    render.save_side_by_side_video(str(out_dir / 'tmp_frames'), s['gp_disp'],
                                   s['rp_disp'], video_fn, delete_tmp=True)
    if not render.have_ffmpeg():
        video_fn = str(Path(video_fn).with_suffix('.gif'))
    elif audio_path:
        render.save_video_from_audio_video(
            audio_path, video_fn, str(out_dir / f'{speaker}_with_audio.mp4'))
    return dict(video=video_fn, pck_mean=s['pck_mean'])


def _flatten_bt(pose: np.ndarray) -> np.ndarray:
    """(B, T, 104) -> (B*T, 2, 52) keypoints for PCK."""
    kp = pose_blocks_to_keypoints(pose)
    return kp.reshape(-1, 2, 52)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--path2data', default='./pats/data')
    ap.add_argument('--speaker', default='oliver')
    ap.add_argument('--ckpt', default=None)
    ap.add_argument('--out', default='./videos')
    ap.add_argument('--sample', type=int, default=1)
    ap.add_argument('--batch_size', type=int, default=256)
    ap.add_argument('--audio', default=None,
                    help='optional wav to mux into the video')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    result = run(args.path2data, args.speaker, args.ckpt, args.out,
                 sample_idx=args.sample, batch_size=args.batch_size,
                 audio_path=args.audio, device=args.device)
    print(result)


if __name__ == '__main__':
    main()
