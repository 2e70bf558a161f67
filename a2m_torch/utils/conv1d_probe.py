"""Times a 1-D convolution's forward + backward on the card, as cuDNN runs
it and as ``nn.layers.conv1d_as_matmul`` runs it.

Run on the card, from the repository root::

    python -m a2m_torch.utils.conv1d_probe

For each of the generator's 1-D convolution shapes (B, T, C_in -> C_out, k,
stride) at B = 128 it prints the mean device time (CUDA events, 5 calls
after 2 warm-up calls) of ``conv1d`` + ``backward`` in f32 with TF32 off:
through cuDNN on the (B, C, T) view the modules use, through cuDNN with
``cudnn.benchmark`` on, and as one matrix product over the k shifted
copies.  It is the measurement behind ``ConvNormRelu``'s choice of the
matrix product under autograd.
"""

from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

from a2m_torch.nn.layers import conv1d_as_matmul

#: (C_in, C_out, T, k, stride): decoder convs, UNet up1, UNet down1, UNet
#: bottleneck
SHAPES = ((256, 256, 64, 3, 1), (1024, 512, 64, 3, 1), (512, 512, 64, 4, 2),
          (1024, 2048, 16, 3, 1))


def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch, rows = 128, []
    for c_in, c_out, t, k, stride in SHAPES:
        pad = int((k - stride) / 2)
        x = torch.randn(batch, t, c_in, device='cuda', requires_grad=True)
        w = (torch.randn(c_out, c_in, k, device='cuda')
             * 0.02).requires_grad_()
        b = torch.zeros(c_out, device='cuda', requires_grad=True)

        def cudnn():
            y = F.conv1d(x.movedim(-1, 1), w, b, stride, pad).movedim(1, -1)
            y.square().sum().backward()

        def matmul():
            conv1d_as_matmul(x, w, b, stride, pad).square().sum().backward()

        row = dict(c_in=c_in, c_out=c_out, t=t, k=k, stride=stride,
                   cudnn_ms=cuda_ms(cudnn), matmul_ms=cuda_ms(matmul))
        torch.backends.cudnn.benchmark = True
        row['cudnn_benchmark_ms'] = cuda_ms(cudnn, warmup=3)
        torch.backends.cudnn.benchmark = False
        rows.append(row)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '--id=0'],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(device=smi, batch=batch, forward_backward=rows),
                     indent=1))


if __name__ == '__main__':
    main()
