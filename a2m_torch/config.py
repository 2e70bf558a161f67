"""Configuration of the port: audio extraction, data, the generator, the
discriminator, the GAN controller, the train steps and the training run.

Own copies of the dataclasses of ``a2m/config.py`` (``AudioConfig`` and
``DataConfig`` ``:17-70``, ``GeneratorConfig`` ``:73-107``,
``DiscriminatorConfig`` ``:111-130``, ``ControllerConfig`` ``:134-166``,
``TrainConfig`` ``:170-244``, ``MeshConfig`` and ``DistConfig``
``:248-288``, ``Config`` ``:291-299``) and of ``BEST_METRICS``,
``validate``, ``apply_overrides`` and ``config_grid`` (``:302-392``), plus
the GCN kernel switches (``fused_gcn``, ``fused_edge``,
``fused_precise``).  ``AudioConfig.use_pallas`` becomes ``device``: in the
port the device alone picks the log-mel kernel (CUDA) or its plain version
(CPU).  The knobs that exist only for the TPU (``remat``, ``rng_impl``,
``donate_buffers``, ``fused_tile``: each kernel here picks its own tile)
have no counterpart here, so an override of one raises ``KeyError`` as any
unknown field does.  ``DistConfig`` brings up a process group
(:mod:`a2m_torch.parallel.launch`), one process per card, and ``MeshConfig``
names its data axis; :func:`validate` refuses what the port does not run
yet: tensor parallelism (``mesh.model > 1``) and one process over several
devices.  ``train.compute_dtype`` is ``'f32'`` or ``'bf16'``
(:func:`torch_dtype`); anything else raises, where a2m falls back to f32
without a word.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence


@dataclass(frozen=True)
class AudioConfig:
    """Audio frontend selection for data preparation."""
    method: str = 'log_mel_512'     # 'log_mel_512' | 'log_mel_400' | 'vggish'
    #: where the Audio modality extracts features: 'cuda' (the exact-mode
    #: log-mel kernel, K2x) or 'cpu' (its float64 plain version)
    device: str = 'cuda'


@dataclass(frozen=True)
class DataConfig:
    path2data: str = './pats/data'
    speakers: tuple[str, ...] = ('oliver', 'noah', 'seth', 'shelly',
                                 'ellen', 'angelica', 'almaram', 'chemistry')
    modalities: tuple[str, ...] = ('pose/data', 'audio/log_mel_512')
    fs_new: tuple[int, ...] = (15, 15)
    batch_size: int = 128
    window_hop: int = 5
    window_seconds: float = 4.3
    shuffle: bool = True
    seed: int = 0
    #: truncate each split to N intervals for quick runs (reference
    #: dataUtils.py:231-237 ``load_data=False`` -> 5 intervals)
    max_intervals_per_split: Optional[int] = None
    style_iters: int = 0            # fixed-iteration alternating-style sampler
    num_training_sample: Optional[int] = None  # few-shot subsample
    quantile_sample: Optional[float] = None    # rebalance by velocity
    quantile_num_training_sample: Optional[int] = None
    weighted: int = 0               # weighted sampler draws per epoch
    repeat_text: int = 1
    filler: int = 0
    #: multi-process data feeding: each process loads a balanced share of
    #: the intervals (``parallel.mesh.balanced_host_slices``).  None = no
    #: sharding; -1 = this process's torch.distributed rank / world size
    process_index: Optional[int] = None
    process_count: Optional[int] = None
    #: bounded-RAM loading: shape metadata at startup, each window's rows
    #: read from the h5 file at access time (off = reference parity)
    lazy_intervals: bool = False
    #: drift-free windowing: each output frame gathers its nearest source
    #: row (``data.windowing.ExactWindowIndex``; off = reference parity)
    exact_windows: bool = False


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
    #: > 0 adds a learned speaker embedding to the encoder features
    num_style_speakers: int = 0
    #: run both 5-layer GCN stacks through the fused stack kernels
    #: (a2m_torch/nn/gcn_kernel.py) instead of the eager layers: the
    #: forward kernel without a gradient, the stash-forward and backward
    #: kernels under autograd
    fused_gcn: bool = False
    #: ignored; accepted so that a2m's configs carry over: a2m's rolled
    #: head loop is the same math, and the port has one kernel for both
    fused_rolled: bool = False
    #: with ``fused_gcn``, route the gradient-free forwards through the
    #: edge-form kernel (a2m's ``_kernel_edge``: tiles of graphs in
    #: joint-major order, routing over constant edge lists) instead of the
    #: dense one; forwards under autograd keep the stash-forward and
    #: backward kernels.  Without ``fused_gcn`` it changes nothing.
    fused_edge: bool = False
    #: fused kernel's matmul operands in f32 instead of bf16 (a2m's
    #: ``fused_gcn_stack(precise=True)``)
    fused_precise: bool = False


@dataclass(frozen=True)
class DiscriminatorConfig:
    in_channels: int = 104
    out_channels: int = 64
    n_downsampling: int = 2
    dropout: float = 0.3
    groups: int = 1
    aux_classes: int = 10
    #: the aux gesture-type classifier head is dead compute unless its CE
    #: loss is applied (``TrainConfig.lambda_aux > 0``); off by default
    use_aux_classifier: bool = False
    out_shape: int = 1
    joint_feat_dim: int = 64
    gat_heads: int = 4
    #: condition D on the batch's log-mel features, adaptive-pooled onto D's
    #: time axis and concatenated before the logits conv
    audio_fusion: bool = False


@dataclass(frozen=True)
class ControllerConfig:
    """DynamicGANTraining parameters."""
    g_lr: float = 5e-4
    d_lr: float = 1e-3
    d_strong_threshold: float = 0.20
    g_weak_threshold: float = 0.80
    g_strong_threshold: float = 0.10
    init_d_freq: int = 1
    init_g_freq: int = 3
    min_d_freq: int = 1
    max_d_freq: int = 2
    min_g_freq: int = 2
    max_g_freq: int = 6
    real_label_smooth: float = 0.98
    fake_label_smooth: float = 0.02
    dynamic_smooth: bool = False
    history_cap: int = 100
    window: int = 10
    # label noise annealing
    max_noise_std: float = 0.01
    min_noise_std: float = 0.002
    anneal_start_epoch: int = 0
    anneal_end_epoch: int = 60
    max_smooth_offset: float = 0.05
    #: bounds on the multiplicative LR adaptation; 0.0 disables either
    g_lr_max: float = 0.0
    d_lr_min: float = 0.0


@dataclass(frozen=True)
class TrainConfig:
    n_epochs: int = 500
    lambda_d: float = 1.0
    lambda_gan: float = 1.0
    lambda_smooth: float = 0.1
    lambda_jerk: float = 0.05
    #: aux classifier CE on D's real branch; needs
    #: ``DiscriminatorConfig.use_aux_classifier``
    lambda_aux: float = 0.0
    #: L1 on the absolute normalised pose (0 = frame differences only)
    lambda_pos: float = 0.0
    #: the run's directory: checkpoints under ``ckpt/`` (one file an epoch
    #: and ``best_gen.npz``) and the loss history ``loss.npy``
    save_dir: str = './save/multi_speaker'
    save_every_epochs: int = 1
    #: validation metric that selects the best-G checkpoint: 'val_g' is the
    #: total dev G loss, 'pos' the absolute-position L1, 'val_pck' dev
    #: PCK@0.2 (higher is better, the only one maximised)
    best_metric: str = 'val_g'
    log_every_batches: int = 200
    #: resume from the latest checkpoint under ``save_dir`` when there is one
    resume: bool = True
    #: warm-start G (and the pose statistics it carries) from a packed
    #: best-G ``.npz`` or a directory holding ``best_gen.npz``, and D from
    #: ``imported_disc.npz`` in that directory (``python -m
    #: a2m_torch.compat`` writes both); optimiser state starts fresh.  A
    #: ``resume`` restore takes precedence.
    init_from: str = ''
    controller: ControllerConfig = field(default_factory=ControllerConfig)
    #: matmul/conv compute dtype of G and D: 'f32' or 'bf16' (a2m's
    #: ``Generator(dtype=jnp.bfloat16)``; parameters, gradients, Adam
    #: moments, BatchNorm statistics and checkpoints stay f32)
    compute_dtype: str = 'f32'
    #: route the gradient-free generator forwards (the fake generation in
    #: ``d_step``, and ``eval_step``) through the fused forward kernel while
    #: ``g_step`` keeps the generator's own setting.  None = on when the
    #: models lie on a CUDA device.
    fused_gcn_eval: Optional[bool] = None
    #: global-norm gradient clipping; 0 disables
    grad_clip_norm: float = 0.0
    #: log each step's MFU once, from the timed steps of the first epoch
    log_mfu: bool = True
    #: write a ``torch.profiler`` trace of the first steps here when set
    profile_dir: str = ''
    #: batches staged on the device ahead of the step by a worker thread
    #: (``Trainer._prefetch``); 0 stages each batch when it is consumed.
    #: 0 by default, unlike a2m's 2: on an H100 a batch of 128 in-memory
    #: windows stages in 3-4 ms beside ~390 ms of steps, and no run of
    #: ``chip_smoke.py`` phase 10 showed the worker thread gaining.  A
    #: loader whose batches are slow to draw (lazy h5 reads) sets it.
    prefetch_batches: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """The data/model mesh (a2m's GSPMD sharding).  The port runs one
    process per card, so its data axis is the process group: ``data`` is 1,
    -1 (all ranks) or the world size, and the batch is split across the
    ranks (:mod:`a2m_torch.parallel.mesh`).  :func:`validate` refuses
    ``model > 1`` (tensor parallelism) and ``data > 1`` in one process
    (launch that many processes instead); both are ROADMAP A13b."""
    data: int = 1                   # batch (data-parallel) axis; -1 = all
    model: int = 1                  # channel-dim (tensor) axis
    axis_names: tuple[str, str] = ('data', 'model')

    def resolved_shape(self, n_devices: int) -> tuple[int, int]:
        """(data, model) with -1 resolved against ``n_devices``."""
        model = max(1, self.model)
        data = self.data if self.data > 0 else max(1, n_devices // model)
        return data, model


@dataclass(frozen=True)
class DistConfig:
    """Multi-process bootstrap (a2m's ``jax.distributed``) on
    ``torch.distributed``: :func:`a2m_torch.parallel.launch.maybe_initialize`
    reads these fields, then ``A2M_COORDINATOR`` / ``A2M_NUM_PROCESSES`` /
    ``A2M_PROCESS_ID``, then (``auto``) torchrun's variables.
    :func:`validate` refuses them set in a process that is not in a
    matching process group."""
    coordinator: str = ''      # 'host:port' of process 0; '' = one process
    num_processes: int = 0     # total process count (0 = from env / auto)
    process_id: int = -1       # this process's id (-1 = from env / auto)
    auto: bool = False         # torchrun's RANK / WORLD_SIZE / MASTER_*


@dataclass(frozen=True)
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    data: DataConfig = field(default_factory=DataConfig)
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    discriminator: DiscriminatorConfig = field(
        default_factory=DiscriminatorConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    dist: DistConfig = field(default_factory=DistConfig)


#: ``train.compute_dtype`` values and the torch dtypes they name
COMPUTE_DTYPES = ('f32', 'bf16')


def torch_dtype(compute_dtype: str):
    """The torch dtype of a ``train.compute_dtype``: ``'f32'`` ->
    ``torch.float32``, ``'bf16'`` -> ``torch.bfloat16``; anything else
    raises ``ValueError``."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f'train.compute_dtype={compute_dtype!r} not one of '
                         f'{COMPUTE_DTYPES}')
    import torch
    return torch.bfloat16 if compute_dtype == 'bf16' else torch.float32


#: validation metrics the eval step reports (train.best_metric choices)
BEST_METRICS = ('val_g', 'val_d', 'reg', 'pos', 'gan', 'bone', 'angle',
                'smooth', 'jerk', 'val_pck')


def validate(cfg: Config) -> Config:
    """Cross-field checks that would otherwise fail deep inside a step,
    and refusals of what the port does not run yet (each names its ROADMAP
    item).  Entry points (``Trainer.from_config``, ``python -m
    a2m_torch.train``) call this after the process group is up (or not);
    returns ``cfg`` unchanged."""
    if cfg.train.best_metric not in BEST_METRICS:
        raise ValueError(
            f'train.best_metric={cfg.train.best_metric!r} not one of '
            f'{BEST_METRICS}')
    if cfg.train.lambda_aux > 0 and not cfg.discriminator.use_aux_classifier:
        raise ValueError(
            'train.lambda_aux > 0 requires discriminator.use_aux_classifier')
    torch_dtype(cfg.train.compute_dtype)
    import torch.distributed as dist
    up = dist.is_available() and dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if up else (0, 1)
    if cfg.mesh.model > 1:
        raise ValueError(
            f'mesh.model={cfg.mesh.model}: the port has no tensor '
            f'parallelism (ROADMAP A13b); it runs data parallel, one '
            f'process per card')
    if cfg.mesh.data not in (1, -1, world):
        if world == 1:
            raise ValueError(
                f'mesh.data={cfg.mesh.data} in one process: the port runs '
                f'one process per card (ROADMAP A13, A13b); launch '
                f'{cfg.mesh.data} processes (A2M_COORDINATOR / '
                f'A2M_NUM_PROCESSES / A2M_PROCESS_ID, or torchrun with '
                f'dist.auto=true)')
        raise ValueError(
            f'mesh.data={cfg.mesh.data} in a group of {world} processes: '
            f'set mesh.data=-1 (or {world}); ROADMAP A13')
    d = cfg.dist
    if (d.coordinator or d.num_processes > 0 or d.auto) and not up:
        raise ValueError(
            'dist.* set but no process group is up: call '
            'a2m_torch.parallel.launch.maybe_initialize(cfg.dist) first, as '
            'python -m a2m_torch.train does (ROADMAP A13)')
    if up and ((d.num_processes > 0 and d.num_processes != world)
               or (d.process_id >= 0 and d.process_id != rank)):
        raise ValueError(
            f'dist.num_processes={d.num_processes} dist.process_id='
            f'{d.process_id}, but this is rank {rank} of {world} '
            f'(ROADMAP A13)')
    return cfg


def _set_nested(cfg: Any, dotted: str, value: str) -> Any:
    head, _, rest = dotted.partition('.')
    if not hasattr(cfg, head):
        raise KeyError(
            f'unknown config field {head!r} on {type(cfg).__name__}')
    if rest:
        sub = _set_nested(getattr(cfg, head), rest, value)
        return dataclasses.replace(cfg, **{head: sub})
    cur = getattr(cfg, head)
    if isinstance(cur, bool):
        parsed: Any = value.lower() in ('1', 'true', 'yes')
    elif isinstance(cur, int):
        parsed = int(value)
    elif isinstance(cur, float):
        parsed = float(value)
    elif isinstance(cur, tuple):
        elem = type(cur[0]) if cur else str
        parsed = tuple(elem(v) for v in value.split(','))
    elif cur is None:
        low = value.lower()
        if low in ('true', 'false', 'yes', 'no'):
            parsed = low in ('true', 'yes')
        elif low in ('none', 'null'):
            parsed = None
        elif value.replace('.', '', 1).isdigit():
            parsed = float(value) if '.' in value else int(value)
        else:
            parsed = value
    else:
        parsed = value
    return dataclasses.replace(cfg, **{head: parsed})


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply ``key.path=value`` overrides, as a2m's CLI takes them.

    Example: ``apply_overrides(cfg, ["data.batch_size=4",
    "train.n_epochs=1"])``
    """
    for item in overrides:
        key, _, value = item.partition('=')
        cfg = _set_nested(cfg, key.strip(), value.strip())
    return cfg


def config_grid(base: Config, grid: dict[str, Sequence[str]]) -> list[Config]:
    """Cartesian product of per-key value lists -> list of configs."""
    keys = list(grid.keys())
    return [apply_overrides(base, [f'{k}={v}' for k, v in zip(keys, values)])
            for values in itertools.product(*(grid[k] for k in keys))]
