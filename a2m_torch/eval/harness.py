"""Evaluation harness: a speaker's test split through the generator, PCK at
every requested alpha and L2 (``a2m/eval/harness.py:28-125``).

Usage, from the repository root::

    python -m a2m_torch.eval.harness --path2data ./pats/data \\
        --speaker oliver --ckpt ./save/multi_speaker/ckpt [--device cpu]

The generator's output is denormalised with the pose statistics the
checkpoint carries (else those of the loader's train split), and scored
against the neck-subtracted ground truth on the unpadded rows.  On CUDA the
generator's GCN stacks run the fused forward kernel (bf16 operands, or f32
with ``cfg.generator.fused_precise``); on the CPU the config's
``fused_gcn`` stands.  Reading PATS h5 files needs ``h5py`` and
``pandas``; ``loader`` (an object with ``.train`` and ``.test``) takes
their place.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from a2m_torch.config import Config
from a2m_torch.data.normalization import (denormalize_pose,
                                          get_mean_std_necksub,
                                          neck_subtract)
from a2m_torch.device import resolve_device
from a2m_torch.eval.metrics import compute_pck, l2_pose_error


def evaluate_speaker(path2data, speaker: str, ckpt=None,
                     batch_size: int = 128, alpha=0.2,
                     cfg: Config | None = None, max_batches=None,
                     render_sample_to=None, device='cuda',
                     loader=None) -> dict:
    """PCK and L2 of the generator over ``speaker``'s test split.

    ``ckpt``: a packed best-G ``.npz`` or a directory holding
    ``best_gen.npz``; None keeps the port's own seeded initialisation
    (seed 0), which a2m's ``PRNGKey(0)`` does not match.  ``alpha`` may be
    a float or a sequence: every alpha is scored in the same pass (``pck``
    is the first's, ``pck_by_alpha`` all).  ``loader`` replaces the
    ``DataLoader`` over ``path2data``.  ``render_sample_to``: a directory
    that receives a sample video of the first test batch
    (:func:`a2m_torch.viz.generate_video.run`, given this ``loader`` and
    ``device``), whose file is returned as ``video``."""
    from a2m_torch.models.generator import Generator
    from a2m_torch.train.checkpoint import load_any_generator_ckpt
    from a2m_torch.weights import from_jax_variables

    cfg = cfg or Config()
    dev = resolve_device(device)
    given_loader = loader
    if loader is None:
        from a2m_torch.data.dataset import DataLoader
        loader = DataLoader(path2data=path2data, speaker=[speaker],
                            modalities=['pose/data', 'audio/log_mel_512'],
                            fs_new=[15, 15], batch_size=batch_size,
                            window_hop=5, shuffle=False, device=str(dev))
    g_cfg = cfg.generator
    if dev.type == 'cuda':
        g_cfg = dataclasses.replace(g_cfg, fused_gcn=True, fused_edge=False)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        generator = Generator(g_cfg)
    mean = std = None
    if ckpt is not None:
        best = load_any_generator_ckpt(ckpt)
        if best is None:
            raise FileNotFoundError(f'no best_gen checkpoint at {ckpt}')
        generator.load_state_dict(from_jax_variables(best['variables'],
                                                     generator))
        # the stats the model was trained with: those of this loader's
        # train split differ whenever the evaluated data differs from the
        # training data (a multi-speaker checkpoint scored per speaker)
        if 'mean' in best:
            mean, std = best['mean'], best['std']
    if mean is None:
        mean, std = get_mean_std_necksub(loader.train)
    generator = generator.to(dev).eval()
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=dev)
    std_t = torch.as_tensor(std, dtype=torch.float32, device=dev)

    alphas = ((alpha,) if isinstance(alpha, (int, float)) else tuple(alpha))
    pcks: dict = {a: [] for a in alphas}
    l2s, n_clips = [], 0
    for i, batch in enumerate(loader.test):
        if max_batches is not None and i >= max_batches:
            break
        with torch.inference_mode():
            audio = torch.as_tensor(batch['audio/log_mel_512'],
                                    dtype=torch.float32).to(dev)
            gen = denormalize_pose(generator(audio), mean_t, std_t)
            m = torch.as_tensor(np.asarray(batch['mask']) > 0, device=dev)
            real = torch.as_tensor(neck_subtract(batch['pose/data']),
                                   dtype=torch.float32).to(dev)
            # (N, T, 104) -> (N * T, 2, 52) keypoint frames
            gk = gen[m].reshape(-1, 2, 52)
            rk = real[m].reshape(-1, 2, 52)
            for a in alphas:
                pcks[a].append(compute_pck(gk, rk, alpha=a))
            l2s.append(l2_pose_error(gk, rk))
        n_clips += int(m.sum())

    by_alpha = {a: (float(torch.cat(v).mean()) if v else None)
                for a, v in pcks.items()}
    result = dict(speaker=speaker, n_clips=n_clips, pck=by_alpha[alphas[0]],
                  pck_alpha=alphas[0],
                  pck_by_alpha={str(a): v for a, v in by_alpha.items()},
                  l2=float(torch.stack(l2s).double().mean()) if l2s
                  else None)
    if render_sample_to is not None and n_clips:
        from a2m_torch.viz.generate_video import run as render_run
        vid = render_run(path2data, speaker, ckpt, render_sample_to,
                         batch_size=batch_size, cfg=cfg, device=device,
                         loader=given_loader)
        result['video'] = vid['video']
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--path2data', default='./pats/data')
    ap.add_argument('--speaker', default='oliver')
    ap.add_argument('--ckpt', default=None)
    ap.add_argument('--batch_size', type=int, default=128)
    ap.add_argument('--alpha', type=float, nargs='+', default=[0.2])
    ap.add_argument('--render_to', default=None)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    alpha = args.alpha[0] if len(args.alpha) == 1 else args.alpha
    print(json.dumps(evaluate_speaker(
        args.path2data, args.speaker, args.ckpt, args.batch_size, alpha,
        render_sample_to=args.render_to, device=args.device)))


if __name__ == '__main__':
    main()
