"""Model configuration of the port (eval slice).

The fields of ``a2m/config.py::GeneratorConfig`` (``:73-107``) that the
generator reads, plus the GCN kernel switches.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GeneratorConfig:
    time_steps: int = 64
    in_channels: int = 256
    out_channels: int = 256
    out_feats: int = 104
    body_feats: int = 20
    num_body_joints: int = 10
    num_hand_joints: int = 42
    joint_feat_dim: int = 64
    dropout: float = 0.2
    gat_heads: int = 4
    #: run both 5-layer GCN stacks through the fused stack kernel
    #: (a2m_torch/nn/gcn_kernel.py) instead of the eager layers
    fused_gcn: bool = False
    #: ignored; accepted so that a2m's configs carry over: a2m's rolled
    #: head loop is the same math, and the port has one kernel for both
    fused_rolled: bool = False
    #: fused kernel's matmul operands in f32 instead of bf16 (a2m's
    #: ``fused_gcn_stack(precise=True)``)
    fused_precise: bool = False
