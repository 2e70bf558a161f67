"""Times the streaming server's fused call on the card by how its input
arrives: the number of ``pipeline_groups``, and the upload's share.

Run on the card, from the repository root::

    python -m a2m_torch.utils.stream_probe [--streams 8] [--seconds 60]

It builds ``pipeline.build_server()`` (flagship generator, GCN stacks on
the edge-form kernel), makes seeded f32 streams at 45.6 kHz and prints one
JSON object: the mean wall time per ``serve(...)`` call (host clock around
5 calls after 3 warm-up calls, each ending in the download of the poses)
for 1, 2, 4 and 8 groups with the upload from host memory and with the
input already on the card, and the time of the staging and upload alone.
It is the measurement behind PERF.md's statement that groups do not pay on
this card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from a2m_torch.eval import streaming
from a2m_torch.pipeline import SR, build_server


def host_ms(fn, iters: int = 5, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--streams', type=int, default=8)
    ap.add_argument('--seconds', type=int, default=60)
    args = ap.parse_args()
    serve = build_server()
    gen = torch.Generator().manual_seed(0)
    waves = [(torch.randn(SR * args.seconds, generator=gen) * 0.1).numpy()
             for _ in range(args.streams)]
    on_card = [torch.from_numpy(w).cuda() for w in waves]
    dev = torch.device('cuda')
    groups = [g for g in (1, 2, 4, 8) if args.streams % g == 0]
    half = args.streams // 2
    out = dict(
        upload_ms={g: host_ms(lambda: serve(waves, pipeline_groups=g))
                   for g in groups},
        on_card_ms={g: host_ms(lambda: serve(on_card, pipeline_groups=g))
                    for g in groups},
        staging_and_upload_ms=host_ms(lambda: streaming._upload(waves, dev)),
        staging_and_upload_two_groups_ms=host_ms(lambda: [
            streaming._upload(waves[:half], dev, True),
            streaming._upload(waves[half:], dev, True)]),
        upload_mb=sum(w.nbytes for w in waves) / 1e6)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '--id=0'],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(device=smi, streams=args.streams,
                          seconds=args.seconds, **out), indent=1))


if __name__ == '__main__':
    main()
