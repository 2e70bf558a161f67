"""Skeleton and audio constants of the audio->pose path.

The port's own copy of what it needs from ``a2m/constants.py`` (the port
imports nothing of ``a2m``): the body/hand skeleton graphs
(``a2m/constants.py:24-130``) and the pose-rate audio constants
(``:179-190``).
"""

from __future__ import annotations

import numpy as np

#: parent index per joint; -1 == root (Neck).  Block pose layout
#: ``[x_0..x_51, y_0..y_51]``.
PARENTS: tuple[int, ...] = (
    -1,
    0, 1, 2,
    0, 4, 5,
    0, 7, 7,
    6,
    10, 11, 12, 13,
    10, 15, 16, 17,
    10, 19, 20, 21,
    10, 23, 24, 25,
    10, 27, 28, 29,
    3,
    31, 32, 33, 34,
    31, 36, 37, 38,
    31, 40, 41, 42,
    31, 44, 45, 46,
    31, 48, 49, 50,
)

NUM_BODY_JOINTS = 10   # Neck..LEye
NUM_HAND_JOINTS = 42   # LHandRoot..RHandLittle4


def body_parents() -> list[int]:
    """Body subgraph parents, clamped to -1 outside the first 10 joints."""
    return [p if p < NUM_BODY_JOINTS else -1
            for p in PARENTS[:NUM_BODY_JOINTS]]


def hand_parents() -> list[int]:
    """Hand subgraph parents re-indexed by -10; wrist-attached roots -> -1."""
    return [p - 10 if p >= 10 else -1
            for p in PARENTS[10:10 + NUM_HAND_JOINTS]]


def _edges_from_parents(parents: list[int]) -> np.ndarray:
    """Bidirectional (child<->parent) edge list, shape (E, 2) of (src, dst)."""
    edges = []
    for i, par in enumerate(parents):
        if par != -1:
            edges.append((par, i))
            edges.append((i, par))
    return np.asarray(edges, dtype=np.int32).reshape(-1, 2)


def body_edges() -> np.ndarray:
    return _edges_from_parents(body_parents())


def hand_edges() -> np.ndarray:
    return _edges_from_parents(hand_parents())


def adjacency_from_edges(edges: np.ndarray, num_nodes: int,
                         self_loops: bool = False) -> np.ndarray:
    """Dense adjacency A[dst, src] = 1 for each directed edge (src, dst)."""
    adj = np.zeros((num_nodes, num_nodes), dtype=np.float32)
    for src, dst in edges:
        adj[dst, src] = 1.0
    if self_loops:
        adj = np.maximum(adj, np.eye(num_nodes, dtype=np.float32))
    return adj


POSE_FPS = 15                  # skeleton sampling rate (Hz)
WINDOW_SECONDS = 4.3           # model window length
FRAMES_PER_WINDOW = int(WINDOW_SECONDS * POSE_FPS)  # 64

#: feature-rate map per audio preprocessing method, with the reference's
#: deliberate int() truncations.
AUDIO_FS_MAP = {
    'log_mel_512': int(45.6 * 1000 / 512),   # 89 Hz
    'log_mel_400': int(16.52 * 1000 / 160),  # 103 Hz
    'silence': 15,
}
