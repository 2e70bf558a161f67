"""Multi-process bootstrap on ``torch.distributed``.

Counterpart of ``a2m/parallel/launch.py``.  a2m brings up
``jax.distributed`` so that every process sees the global device set and
runs one global program; the port runs one process per card (one rank),
each with its own copy of the models, and keeps a2m's global-batch
semantics with explicit collectives (:mod:`a2m_torch.parallel.mesh`).

Launch, one command per process, identical but for the process id::

    A2M_COORDINATOR=host0:8476 A2M_NUM_PROCESSES=2 A2M_PROCESS_ID=$i \\
        python -m a2m_torch.train mesh.data=-1 data.batch_size=64

or through torchrun, whose ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/
``MASTER_ADDR``/``MASTER_PORT`` are read with ``dist.auto=true``::

    torchrun --nproc_per_node 8 -m a2m_torch.train dist.auto=true \\
        mesh.data=-1

``data.batch_size`` is per process; the global batch is ``batch_size x
world size``.  The loader gives each process a disjoint, balanced slice of
the intervals with equal step counts (``data.process_count=-1``).

With ``mesh.model=m`` (and ``mesh.data=-1``) the ranks form a grid of
``world / m`` data ranks x ``m`` model ranks
(:func:`a2m_torch.parallel.mesh.make_mesh`, which ``train.__main__``'s
``bootstrap`` calls): the ``m`` consecutive ranks of a model group read
the same slice, hold the channel slices of the layers ``TP_RULES`` shard,
and the global batch is ``batch_size x world / m``.

Backend: NCCL when every rank has a card of its own; gloo on the CPU, or
when two ranks share a card (NCCL refuses two ranks on one device; gloo
stages CUDA tensors through the host).  Local rank ``i`` uses card
``i % cards`` of those its process sees.  With ``A2M_*`` the ranks learn
through rank 0's store which of them share a host (by host name) and
which card each took (by its UUID), so that a launch over several hosts
picks NCCL too; torchrun names the local ranks itself and gives every
process all of its host's cards.  A second group, always gloo, carries the
host-side exchanges (:func:`host_barrier`, :func:`sync_global_moments`)
with timeouts of their own, as a2m's coordination service does.
"""

from __future__ import annotations

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

__all__ = ['host_barrier', 'host_group', 'is_distributed',
           'maybe_initialize', 'shutdown', 'sync_global_moments']

#: seconds a collective may wait for its peers: long enough for a rank's
#: first kernel build (a2m documents Gloo's 30 s deadline biting,
#: ``launch.py:97-113``)
TIMEOUT_S = 1800.0

#: what :func:`maybe_initialize` set up: backend, device, host group
_STATE: dict = {}


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, '')
    return int(v) if v else default


def _topology(dist_cfg):
    """``(addr, port, world, rank, local)`` from the ``DistConfig`` fields,
    then ``A2M_*``, then (``auto``) torchrun's variables; None when nothing
    asks for a process group.  ``local`` is torchrun's ``(LOCAL_RANK,
    LOCAL_WORLD_SIZE)``, or None with ``A2M_*``, which say nothing of
    hosts."""
    coordinator = (getattr(dist_cfg, 'coordinator', '')
                   or os.environ.get('A2M_COORDINATOR', ''))
    auto = bool(getattr(dist_cfg, 'auto', False))
    if not coordinator and not auto:
        return None
    if coordinator:
        world = (getattr(dist_cfg, 'num_processes', 0)
                 or _env_int('A2M_NUM_PROCESSES', 0))
        rank = getattr(dist_cfg, 'process_id', -1)
        if rank < 0:
            rank = _env_int('A2M_PROCESS_ID', -1)
        if world <= 0 or rank < 0:
            raise ValueError(
                'dist.coordinator set but num_processes/process_id are '
                'not: pass dist.num_processes=N dist.process_id=I or set '
                'A2M_NUM_PROCESSES / A2M_PROCESS_ID')
        addr, _, port = coordinator.rpartition(':')
        return addr, int(port), world, rank, None
    # torchrun: the runtime supplies the topology
    world, rank = _env_int('WORLD_SIZE', -1), _env_int('RANK', -1)
    local = (_env_int('LOCAL_RANK', -1), _env_int('LOCAL_WORLD_SIZE', -1))
    addr, port = (os.environ.get('MASTER_ADDR', ''),
                  os.environ.get('MASTER_PORT', ''))
    if world <= 0 or rank < 0 or min(local) < 0 or not addr or not port:
        raise ValueError(
            'dist.auto: RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, '
            'MASTER_ADDR and MASTER_PORT must be set (torchrun sets them)')
    return addr, int(port), world, rank, local


def _exchange(store, world: int, rank: int, key: str, value: str
              ) -> list[str]:
    """Every rank's ``value`` of ``key``, by rank, through ``store``."""
    store.set(f'a2m/{key}/{rank}', value)
    return [store.get(f'a2m/{key}/{r}').decode() for r in range(world)]


def _place(store, world: int, rank: int, host: str, cards: int, card_id
           ) -> tuple[int, int, bool]:
    """(card index, ranks on this host, whether ranks share cards) of
    ``rank``: every rank's ``host`` is exchanged through ``store``, the
    rank takes card ``local rank % cards``, where its local rank is its
    place among the ranks of its host, and then every rank's
    ``card_id(index)`` is exchanged."""
    hosts = _exchange(store, world, rank, 'host', host)
    same = [r for r, h in enumerate(hosts) if h == host]
    index = same.index(rank) % cards
    ids = _exchange(store, world, rank, 'card', card_id(index))
    return index, len(same), len(set(ids)) < world


def _card_id(index: int) -> str:
    """What names card ``index`` of this process across the group."""
    props = torch.cuda.get_device_properties(index)
    return f'{socket.gethostname()}/{getattr(props, "uuid", index)}'


def maybe_initialize(dist_cfg=None, device='cuda') -> bool:
    """Bring up the process group when configured; no-op otherwise.

    Resolution order: explicit ``DistConfig`` fields, then the
    ``A2M_COORDINATOR`` / ``A2M_NUM_PROCESSES`` / ``A2M_PROCESS_ID`` env
    vars, then (``dist.auto``) torchrun's ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` / ``MASTER_ADDR`` /
    ``MASTER_PORT``.  ``device`` is where the run trains (``'cuda'`` or
    ``'cpu'``): it picks the backend and, on CUDA, makes this rank's card
    the current device (see :func:`rank_device`).  Returns True iff a
    process group is (now) active; a second call returns that without
    initialising again."""
    if dist.is_initialized():
        return True
    topo = _topology(dist_cfg)
    if topo is None:
        return False
    addr, port, world, rank, local = topo
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if local is None:
        # rank 0 serves the rendezvous; the ranks learn through it which
        # of them share a host and a card
        store = dist.TCPStore(addr, port, world, is_master=rank == 0,
                              timeout=timeout)
        rendezvous = dict(store=store)
    else:
        store, rendezvous = None, dict(init_method=f'tcp://{addr}:{port}')
    if torch.device(device).type == 'cuda':
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError('a2m_torch: CUDA is not available; pass '
                               'device=cpu to run the port on the CPU')
        if local is None:
            index, local_world, shared = _place(
                store, world, rank, socket.gethostname(), cards, _card_id)
        else:
            # torchrun gives every process all of its host's cards
            local_rank, local_world = local
            index, shared = local_rank % cards, local_world > cards
        backend = 'gloo' if shared else 'nccl'
        torch.cuda.set_device(index)
        rank_dev = torch.device('cuda', index)
        placement = (f'cuda:{index} of {cards} card(s), {local_world} '
                     f'rank(s) on this host'
                     + (', ranks share cards' if shared else ''))
    else:
        backend, rank_dev, placement = 'gloo', torch.device('cpu'), 'cpu'
    dist.init_process_group(backend, world_size=world, rank=rank,
                            timeout=timeout, **rendezvous)
    host = (dist.group.WORLD if backend == 'gloo'
            else dist.new_group(backend='gloo', timeout=timeout))
    _STATE.update(backend=backend, device=rank_dev, host_group=host,
                  placement=placement)
    return True


def is_distributed() -> bool:
    """True when this process is one of a group of more than one."""
    return dist.is_initialized() and dist.get_world_size() > 1


def rank_device() -> torch.device | None:
    """The device :func:`maybe_initialize` gave this rank (None before)."""
    return _STATE.get('device') if dist.is_initialized() else None


def describe() -> str:
    """``backend gloo, cuda:0 of 1 card(s), 2 rank(s) on this host``."""
    if not dist.is_initialized():
        return 'one process'
    return f'backend {dist.get_backend()}, {_STATE.get("placement", "?")}'


def host_barrier(name: str, timeout_s: float = TIMEOUT_S) -> None:
    """Align all processes at ``name`` on the host group, waiting at most
    ``timeout_s`` (a rank that does not arrive is named in the error).
    a2m brackets each step's first execution with it; the port needs it
    where rank 0 writes a file that the others read or outlive."""
    if not is_distributed():
        return
    try:
        dist.monitored_barrier(group=_STATE['host_group'],
                               timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise RuntimeError(f'host_barrier {name!r}: {e}') from e


def host_group():
    """The gloo group of all ranks (host barriers and host-side sums);
    None without a process group."""
    return _STATE.get('host_group') if dist.is_initialized() else None


def sync_global_moments(mean_sum, sq_sum, batch_num):
    """All-reduce per-data-rank normalisation moments to dataset-global
    statistics.

    Each data rank computes moments over its interval slice
    (:func:`a2m_torch.data.normalization.get_moments_necksub`); summing
    ``(mean_sum, sq_sum, batch_num)`` across the data group (the ranks of
    one model index: the others hold the same slices) gives exactly the
    one-process statistics (the reference's estimator is a plain sum over
    batches).  The sums travel in float64 on the host, once at start."""
    mean_sum = np.asarray(mean_sum, np.float64)
    sq_sum = np.asarray(sq_sum, np.float64)
    if not dist.is_initialized():
        return mean_sum, sq_sum, batch_num
    flat = torch.from_numpy(np.concatenate(
        [mean_sum.ravel(), sq_sum.ravel(), [float(batch_num)]]))
    from a2m_torch.parallel import mesh
    grid = mesh.current_mesh()
    dist.all_reduce(flat, group=_STATE['host_group'] if grid is None
                    else grid.host_data_group)
    flat = flat.numpy()
    n = mean_sum.size
    return (flat[:n].reshape(mean_sum.shape),
            flat[n:2 * n].reshape(sq_sum.shape), float(flat[-1]))


def shutdown() -> None:
    """Meet every rank at ``a2m_train_exit``, then destroy the process
    group (a no-op in one process).  The primary spends longer on
    checkpoint writes; without the barrier a rank that leaves first tears
    down the group under it."""
    if not dist.is_initialized():
        return
    from a2m_torch.parallel import mesh
    host_barrier('a2m_train_exit')
    mesh.clear_mesh()
    dist.destroy_process_group()
    _STATE.clear()
