"""Rank mesh: shard a batch of games over processes and aggregate statistics, ported
from ``dgsqp_tpu/parallel/mesh.py``.

The JAX package runs one program over a 1-D ``games`` mesh of devices.  PyTorch has no
single-process SPMD, and every path of the port is host-bound, so here each device gets
its own process (a *rank*): the ranks run the same code, each on its contiguous block of
the batch (the layout of ``PartitionSpec('games')``), and talk through
``torch.distributed``.  One Python thread issuing to k devices would run their host work
one after the other.

* :func:`spawn_ranks` starts k ranks from one process (``torch.multiprocessing``, the
  ``spawn`` start method) and returns what each rank's function returned;
  :func:`init_distributed` joins processes started apart, on one host or several, from
  ``DGSQP_COORDINATOR``, ``DGSQP_NUM_PROCESSES``, ``DGSQP_PROCESS_ID`` and
  ``DGSQP_DEVICE``.
* :func:`games_mesh` describes the ranks (:class:`GamesMesh`): the world size, this rank,
  each rank's device and the process group its collectives use.
* Devices are named, never guessed: ranks share a device only when the caller names it
  once a rank (``['cuda:0', 'cuda:0']``, ``['cpu'] * k``), and asking for more ranks than
  CUDA devices without such a list raises.
* The backend is ``nccl`` where every rank has a card of its own, ``gloo`` otherwise (on
  the CPU, and for ranks that share a card, which NCCL refuses); gloo's collectives
  stage through host copies.

Every process group has a timeout, and every spawned rank a time limit: a rank that
dies fails the run instead of leaving the others waiting in a collective.
"""
from __future__ import annotations

import datetime
import math
import os
import queue
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ENV_COORDINATOR = 'DGSQP_COORDINATOR'
ENV_NUM_PROCESSES = 'DGSQP_NUM_PROCESSES'
ENV_PROCESS_ID = 'DGSQP_PROCESS_ID'
ENV_DEVICE = 'DGSQP_DEVICE'
DEFAULT_TIMEOUT_S = 900.0

# This process's membership of a rank group: its device, whether the group was joined
# across hosts, and the mesh once built.  A process belongs to at most one group, as
# torch.distributed's default group is itself one a process.
_MEMBERSHIP: dict = {}


def resolve_devices(devices, n: int) -> List[torch.device]:
    """One device a rank for ``n`` ranks.

    ``devices`` is ``None`` (CUDA devices 0..n-1; raises when there are fewer than n),
    ``'cuda'`` (the same), ``'cpu'`` (n ranks on the CPU), or one device a rank as a list
    or a comma-separated string (``'cuda:0,cuda:0'`` puts two ranks on one card).  A CUDA
    device in a list names its index."""
    if isinstance(devices, str):
        devices = devices.split(',')
    if devices is None or list(devices) == ['cuda']:
        if not torch.cuda.is_available():
            raise RuntimeError(f'{n} rank(s) need a CUDA device each and none is '
                               "available: name the devices (for example ['cpu'] * n)")
        count = torch.cuda.device_count()
        if n > count:
            raise ValueError(f'{n} ranks and {count} CUDA device(s): to share a card, '
                             'name it once a rank (for example cuda:0,cuda:0)')
        return [torch.device('cuda', i) for i in range(n)]
    devices = [torch.device(d) if isinstance(d, str) else d for d in devices]
    if len(devices) == 1 and devices[0] == torch.device('cpu'):
        return devices * n
    if len(devices) != n:
        raise ValueError(f'{len(devices)} device(s) named for {n} ranks')
    for d in devices:
        if d.type == 'cuda' and d.index is None:
            raise ValueError("name a rank's CUDA device with its index (cuda:0)")
    return devices


@dataclass(frozen=True, eq=False)
class GamesMesh:
    """The ranks a batch of games is sharded over.

    Rank r holds rows ``[r * B / size, (r + 1) * B / size)`` of a global batch of B.  The
    collectives below run on ``group`` and return on this rank's ``device``."""
    size: int
    rank: int
    device: torch.device
    devices: Tuple[str, ...]     # each rank's device, as 'host/device'
    backend: Optional[str]       # None for one rank
    group: object = None
    multi_host: bool = False     # joined by init_distributed: the fixed layout
    timeout_s: float = DEFAULT_TIMEOUT_S

    def block(self, n: int) -> Tuple[int, int]:
        """This rank's rows of a global batch of ``n``."""
        if n % self.size:
            raise ValueError(f'a batch of {n} does not divide over {self.size} ranks')
        b = n // self.size
        return self.rank * b, (self.rank + 1) * b

    def _comm(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.backend == 'gloo' else t

    def all_gather(self, t: torch.Tensor, host: bool = False):
        """Every rank's ``t`` (equal shapes), concatenated in rank order along dim 0:
        a tensor on this rank's device, or a numpy array with ``host=True``."""
        if self.size == 1:
            return t.cpu().numpy() if host else t
        x = self._comm(t)
        outs = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(outs, x, group=self.group)
        out = torch.cat(outs)
        return out.cpu().numpy() if host else out.to(self.device)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return t
        x = self._comm(t).clone()
        dist.all_reduce(x, group=self.group)
        return x.to(self.device)

    def all_gather_rows(self, tree):
        """A tensor or a NamedTuple of tensors, each rank holding its block of rows:
        the whole batch in rank order on every rank, with one collective."""
        if self.size == 1:
            return tree
        n = _rows(tree)
        packed, layout = pack_rows(tree, n)
        return unpack_rows(self.all_gather(packed), layout, tree)

    def all_to_all_rows(self, rows: torch.Tensor, send_counts: Sequence[int],
                        recv_counts: Sequence[int]) -> torch.Tensor:
        """Send ``send_counts[d]`` consecutive rows of ``rows`` to rank d and receive
        ``recv_counts[s]`` rows from rank s, in rank order."""
        x = self._comm(rows)
        out = x.new_empty((int(sum(recv_counts)),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x, [int(c) for c in recv_counts],
                               [int(c) for c in send_counts], group=self.group)
        return out.to(self.device)


# ------------------------------------------------------------------ row packing
def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for child in tree for leaf in _leaves(child)]


def _rebuild(like, leaves):
    if isinstance(like, torch.Tensor):
        return next(leaves)
    children = [_rebuild(child, leaves) for child in like]
    return type(like)(*children) if hasattr(like, '_fields') else type(like)(children)


def _rows(tree) -> int:
    return int(_leaves(tree)[0].shape[0])


def pack_rows(tree, n: int):
    """The rows of every leaf of ``tree`` (a tensor, or nested tuples and NamedTuples
    of tensors, each with n rows) side by side as bytes: ``(packed (n, bytes) uint8,
    layout)``."""
    cols, layout = [], []
    for a in _leaves(tree):
        width = math.prod(a.shape[1:])
        b = a.reshape(n, width).contiguous().view(torch.uint8)
        cols.append(b)
        layout.append((a.dtype, tuple(a.shape[1:]), b.shape[1]))
    return torch.cat(cols, dim=1), layout


def unpack_rows(packed: torch.Tensor, layout, like):
    """Inverse of :func:`pack_rows`, in the structure of ``like``."""
    m, off, out = packed.shape[0], 0, []
    for dtype, shape, nbytes in layout:
        if nbytes == 0:
            out.append(packed.new_empty((m,) + shape, dtype=dtype))
            continue
        col = packed[:, off:off + nbytes].clone(memory_format=torch.contiguous_format)
        out.append(col.view(dtype).reshape((m,) + shape))
        off += nbytes
    return _rebuild(like, iter(out))


# ------------------------------------------------------------------ joining
def _join(device, init_method: str, world: int, rank: int, timeout_s: float,
          multi_host: bool) -> None:
    device = torch.device(device)
    if device.type == 'cuda':
        if device.index is None:
            raise ValueError("name a rank's CUDA device with its index (cuda:0)")
        torch.cuda.set_device(device)
    # the world group is gloo: it carries the mesh's set-up and, for ranks that share a
    # card or run on the CPU, every collective; games_mesh adds an nccl group where each
    # rank has a card of its own
    dist.init_process_group('gloo', init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _MEMBERSHIP.clear()
    _MEMBERSHIP.update(device=device, multi_host=multi_host, timeout_s=timeout_s)


def leave() -> None:
    """Leave the rank group this process joined (no-op outside one)."""
    _MEMBERSHIP.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join processes started apart (on one host or several) into one rank group.

    The arguments default to ``DGSQP_COORDINATOR`` (``host:port`` of process 0),
    ``DGSQP_NUM_PROCESSES``, ``DGSQP_PROCESS_ID`` and ``DGSQP_DEVICE`` (this process's
    device, e.g. ``cuda:0`` or ``cpu``).  Returns False, joining nothing, when neither
    the coordinator nor the process count is set; True once joined.  A study joined this
    way keeps the fixed layout (no compaction across ranks), as the JAX package does for
    arrays that span hosts."""
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID):
        process_id = int(os.environ[ENV_PROCESS_ID])
    if coordinator_address is None and num_processes is None:
        return False
    device = device or os.environ.get(ENV_DEVICE)
    missing = [name for name, v in ((ENV_COORDINATOR, coordinator_address),
                                    (ENV_NUM_PROCESSES, num_processes),
                                    (ENV_PROCESS_ID, process_id), (ENV_DEVICE, device))
               if v is None]
    if missing:
        raise ValueError(f'init_distributed needs {", ".join(missing)}')
    _join(device, f'tcp://{coordinator_address}', int(num_processes), int(process_id),
          timeout_s, multi_host=True)
    return True


def games_mesh(n_devices: Optional[int] = None, devices=None) -> GamesMesh:
    """The mesh of the rank group this process belongs to (built once, then the same
    object); outside a group, a mesh of one rank on ``devices`` (see
    :func:`resolve_devices`).  ``n_devices`` greater than one outside a group raises:
    start the ranks with :func:`spawn_ranks` or :func:`init_distributed`."""
    if not dist.is_initialized():
        n = n_devices or 1
        if n > 1:
            raise RuntimeError(f'{n} ranks need {n} processes: start them with '
                               'spawn_ranks(fn, n, devices=...) or init_distributed()')
        dev = resolve_devices(devices, 1)[0]
        return GamesMesh(1, 0, dev, (f'{socket.gethostname()}/{dev}',), None)
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f'a mesh of {n_devices} in a rank group of {world}')
    mesh = _MEMBERSHIP.get('mesh')
    if mesh is not None:
        return mesh
    if 'device' not in _MEMBERSHIP:
        raise RuntimeError('the process group was not joined through spawn_ranks or '
                           'init_distributed: its ranks have no devices')
    device, timeout_s = _MEMBERSHIP['device'], _MEMBERSHIP['timeout_s']
    names: List[Optional[str]] = [None] * world
    dist.all_gather_object(names, f'{socket.gethostname()}/{device}')
    own_card = (all('/cuda' in s for s in names) and len(set(names)) == world)
    group, backend = None, 'gloo'
    if own_card:
        group = dist.new_group(backend='nccl',
                               timeout=datetime.timedelta(seconds=timeout_s))
        backend = 'nccl'
    mesh = GamesMesh(world, dist.get_rank(), device, tuple(names), backend, group,
                     _MEMBERSHIP['multi_host'], timeout_s)
    _MEMBERSHIP['mesh'] = mesh
    return mesh


# ------------------------------------------------------------------ launching
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, devices: List[str], fn: Callable,
               args: tuple, results, timeout_s: float) -> None:
    # ranks share the host's cores: a pool of threads in each would make their many small
    # CPU operations wait on one another
    torch.set_num_threads(1)
    try:
        _join(devices[rank], f'tcp://127.0.0.1:{port}', world, rank, timeout_s,
              multi_host=False)
        results.put((rank, True, fn(games_mesh(world), *args)))
    except Exception:
        # reported to the launcher, which stops the other ranks and raises
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        leave()


def spawn_ranks(fn: Callable, n: int, *args, devices=None,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on ``n`` ranks, each a process of its own on its device
    (:func:`resolve_devices`), and return what each returned, in rank order.

    ``fn`` is a module-level function (it is pickled by name) and returns host values
    (numbers, numpy arrays).  Each rank runs torch on one CPU thread.  A rank
    that raises or dies, or a run longer than ``timeout_s``, stops every rank and
    raises here; the process group's collectives time out after ``timeout_s`` too."""
    devs = [str(d) for d in resolve_devices(devices, n)]
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, devs, fn, args, results, timeout_s))
             for r in range(n)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f'rank {dead[0][0]} exited with code {dead[0][1]}')
                if time.monotonic() > deadline:
                    raise TimeoutError(f'{n} ranks ran past {timeout_s} s')
                continue
            if not ok:
                raise RuntimeError(f'rank {rank} failed:\n{value}')
            out[rank] = value
        for r, p in enumerate(procs):
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                raise TimeoutError(f'rank {r} did not exit within {timeout_s} s')
            if p.exitcode != 0:
                raise RuntimeError(f'rank {r} exited with code {p.exitcode}')
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)
        results.close()
    return [out[r] for r in range(n)]


# ------------------------------------------------------------------ batches
def shard_batch(mesh: GamesMesh, arr):
    """This rank's contiguous block of a global batch (numpy array or tensor), as a
    tensor on the rank's device (numpy arrays keep their dtype)."""
    lo, hi = mesh.block(int(arr.shape[0]))
    return torch.as_tensor(arr[lo:hi], device=mesh.device)


def pad_to_multiple(arr, multiple: int):
    """Pad the batch axis up to a multiple by repeating the last row (games a rank must
    divide evenly); returns (padded, original_length).  numpy arrays or tensors."""
    b = arr.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return arr, b
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr[-1:].expand((rem,) + tuple(arr.shape[1:]))]), b
    return np.concatenate([arr, np.repeat(arr[-1:], rem, axis=0)], axis=0), b


def sharded_batch_solve(solve_fn: Callable, mesh: GamesMesh, *batch_args):
    """Solve this rank's block of the global batch with ``solve_fn(*blocks)`` (a result
    NamedTuple with a leading batch dimension) and return the whole batch's result, in
    the original order, on every rank.  The batch divides over the ranks."""
    return mesh.all_gather_rows(solve_fn(*[shard_batch(mesh, a) for a in batch_args]))


def convergence_stats(statuses, mesh: Optional[GamesMesh] = None) -> dict:
    """Counts over every rank's games (``statuses``: this rank's block, or the whole
    batch without a mesh), with one ``all_reduce``: total, converged (conv_abs or
    conv_rel) and the rate, a float32 quotient as the JAX package's mean."""
    st = torch.as_tensor(statuses)
    conv = (st == 1) | (st == 2)
    counts = torch.tensor([st.shape[0], int(conv.sum())], dtype=torch.int64)
    if mesh is not None:
        counts = mesh.all_reduce_sum(counts.to(mesh.device)).cpu()
    total, converged = int(counts[0]), int(counts[1])
    return dict(total=total, converged=converged,
                rate=float(np.float32(converged) / np.float32(total)))
