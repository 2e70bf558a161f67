"""a2m_torch: the PyTorch/CUDA port of a2m for NVIDIA Hopper (H100).

Mirrors the layout of ``a2m/`` and imports nothing of it, nor JAX.  This
slice covers the eval audio->pose path (:mod:`a2m_torch.pipeline`), with
the two TPU kernels of that path as hand-written CUDA kernels under
``a2m_torch/csrc/`` (built at first use by :mod:`a2m_torch._build`).
"""
