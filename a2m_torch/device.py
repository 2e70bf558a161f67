"""Where the port runs: the device check shared by its entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA when it is absent, and
    turns TF32 off for CUDA (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``: cuDNN would otherwise run the f32
    convolutions in TF32, about three decimal digits)."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('a2m_torch: CUDA is not available; pass '
                               'device="cpu" to run the port on the CPU')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
