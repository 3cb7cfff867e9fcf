"""The process group of a multi-process run (the port's counterpart of
``parallel/mesh.py``; reference: slowfast/utils/distributed.py).

The JAX package runs one process per host and compiles every step over
the global batch. The port runs one process per GPU, as the reference
does:

- world size ``NUM_SHARDS x NUM_GPUS``, rank ``SHARD_ID x NUM_GPUS +
  local_rank``, device ``cuda:local_rank``;
- NCCL on the GPU and gloo on the CPU (``DIST_BACKEND``; NCCL with a CPU
  device raises). gloo also carries CUDA tensors' ``all_reduce`` and
  ``broadcast``, which is all that DDP and the BN statistics need, so
  two ranks can share one GPU over gloo;
- a gloo side group for host arrays, barriers and checksums (NCCL
  carries no host tensors; the reference's ``_get_global_gloo_group``);
- the batch sizes of the config stay global: the loader gives each rank
  its share (``data/loader.py``), and what the JAX package reduces over
  the global batch inside its step the port reduces across ranks: BN's
  statistics (``ops/norm.py``), the step's metrics (``engine/state.py``)
  and the eval rows (``all_gather_unaligned``);
- the ranks form the JAX package's ``(data, space)`` mesh
  (``mesh.py::build_mesh``): ``S = TPU.SPATIAL_SHARD`` (1 where it is 0 or
  1) consecutive ranks are a space group, which splits each frame's height
  (``parallel/spatial.py``), and ``D = min(world // S, TPU.DATA_AXIS or
  world // S)`` space groups take the batch. Rank r has data index
  ``r // S`` and space index ``r % S``. The loader, the draws, the
  metrics and the gathers go by the data index and count: every rank of a
  space group holds the same clips, and only its space index 0 counts
  them.

The JAX package's ``compile_fence`` has no counterpart: nothing is
compiled ahead of time here. Its role, keeping ranks from drifting apart
before their first collective, falls to the explicit timeouts of the
group and of ``host_barrier``, and to the kernels' build lock
(``ops/kernels/_build.py``).
"""

from __future__ import annotations

import datetime
import zlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective, the rendezvous or a barrier may wait for a rank
TIMEOUT_S = 1800.0

_gloo = None  # the gloo side group (the default group when it is gloo)
_ckpt = None  # a gloo group of its own for the async checkpoint's thread
_space = (1, None)  # (S, this rank's space group): set by init_distributed


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank, 0 when no process group is up."""
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    """The processes of the run, 1 when no process group is up."""
    return dist.get_world_size() if initialized() else 1


def is_master() -> bool:
    return rank() == 0


def mesh_shape(cfg, world: int) -> tuple:
    """(D, S) of a job of ``world`` processes (``mesh.py::build_mesh``,
    ``mesh_device_count``): S is ``TPU.SPATIAL_SHARD`` above 1, else 1;
    D is ``world // S``, capped at ``TPU.DATA_AXIS`` where it is set. A
    world that S does not divide raises, as JAX's mesh asserts."""
    s = int(cfg.TPU.SPATIAL_SHARD)
    s = s if s > 1 else 1
    if world < s or world % s:
        raise AssertionError(
            f"TPU.SPATIAL_SHARD={s} must divide the job's process count "
            f"({world}) so that every space group is whole")
    d = world // s
    if cfg.TPU.DATA_AXIS:
        d = min(d, int(cfg.TPU.DATA_AXIS))
    return d, s


def space_size() -> int:
    """S: the ranks of a space group (1 without ``TPU.SPATIAL_SHARD``)."""
    return _space[0]


def space_rank() -> int:
    """This rank's index in its space group: the band of rows it holds."""
    return rank() % _space[0]


def space_group():
    """The process group of this rank's space group (None where S is 1)."""
    return _space[1]


def data_rank() -> int:
    """This rank's index on the data axis: its share of the batch."""
    return rank() // _space[0]


def data_size() -> int:
    """D: the shares of the batch (the world where S is 1)."""
    return world_size() // _space[0]


def counts_rows() -> bool:
    """Whether this rank adds its rows to metrics and gathers: space index
    0 of each space group (the others hold the same clips)."""
    return space_rank() == 0


def _timeout(seconds: Optional[float] = None) -> datetime.timedelta:
    return datetime.timedelta(seconds=TIMEOUT_S if seconds is None
                              else seconds)


def init_distributed(cfg, local_rank: int, device,
                     init_method: str = "tcp://localhost:9999") -> None:
    """Join the run's process group as rank ``SHARD_ID x NUM_GPUS +
    local_rank`` of ``NUM_SHARDS x NUM_GPUS`` (the ``--shard_id``,
    ``--num_shards`` and ``--init_method`` contract, docs/MULTIHOST.md),
    over ``cfg.DIST_BACKEND``: ``nccl`` on a CUDA ``device``, ``gloo``
    on either. The group and its gloo side group wait at most
    ``TIMEOUT_S`` for a rank."""
    global _gloo, _ckpt, _space
    device = torch.device(device)
    backend = cfg.DIST_BACKEND
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(
            f"DIST_BACKEND nccl needs a CUDA device, not {device}: set "
            "DIST_BACKEND gloo to run the processes on the CPU")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"DIST_BACKEND {backend}: nccl or gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    world = job_size(cfg)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world,
        rank=cfg.SHARD_ID * cfg.NUM_GPUS + local_rank, timeout=_timeout())
    _gloo = (dist.new_group(backend="gloo", timeout=_timeout())
             if backend != "gloo" else dist.group.WORLD)
    _ckpt = dist.new_group(backend="gloo", timeout=_timeout())
    _, s = mesh_shape(cfg, world)
    group = None
    if s > 1:  # every rank makes every group, in the same order
        for first in range(0, world, s):
            g = (dist.group.WORLD if s == world else
                 dist.new_group(list(range(first, first + s)),
                                timeout=_timeout()))
            if first <= rank() < first + s:
                group = g
    _space = (s, group)


def job_size(cfg) -> int:
    """The processes of the job: ``NUM_SHARDS x NUM_GPUS``, cut to D x S
    on one machine where ``TPU.DATA_AXIS`` leaves GPUs out of the mesh (as
    JAX leaves devices out of it); a job of several machines must be D x S
    already."""
    world = cfg.NUM_SHARDS * cfg.NUM_GPUS
    d, s = mesh_shape(cfg, world)
    if d * s < world and cfg.NUM_SHARDS > 1:
        raise ValueError(
            f"TPU.DATA_AXIS={cfg.TPU.DATA_AXIS} x TPU.SPATIAL_SHARD gives a "
            f"mesh of {d * s} processes, but the job of {cfg.NUM_SHARDS} "
            f"machines has {world}: set NUM_GPUS so that they are equal")
    return d * s


def destroy_distributed() -> None:
    """Leave the process group, where one is up."""
    global _gloo, _ckpt, _space
    if initialized():
        dist.destroy_process_group()
    _gloo, _ckpt, _space = None, None, (1, None)


def gloo_group():
    """The gloo group of the run: host tensors, barriers, checksums (the
    default group where ``init_distributed`` did not make the run's)."""
    return dist.group.WORLD if _gloo is None else _gloo


def checkpoint_group():
    """The gloo group of the async checkpoint (``utils/checkpoint.py``):
    its collectives run on a thread of their own, beside the step's on
    the run's groups. None without a process group."""
    return _ckpt


def host_barrier(name: str, timeout_s: Optional[float] = None) -> None:
    """Every rank waits here for the others, at most ``timeout_s``
    (``TIMEOUT_S`` by default) over the gloo group; a rank that does not
    come is named in the error. The identity in one process."""
    if world_size() == 1:
        return
    try:
        dist.monitored_barrier(group=gloo_group(), timeout=_timeout(timeout_s),
                               wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"host barrier {name!r}: {e}") from e


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` summed over the ranks, in place, over the default group
    (on the device for NCCL). The identity in one process."""
    if world_size() > 1:
        dist.all_reduce(tensor)
    return tensor


def all_reduce_data(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor``, a count or sum of this rank's clips, summed over the
    data axis, in place: every space group adds it once (its space index
    0's). The identity in one process."""
    if world_size() > 1:
        if not counts_rows():
            tensor.zero_()
        dist.all_reduce(tensor)
    return tensor


def global_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int],
                dim: int = 0) -> torch.Tensor:
    """``draw(shape)``, a random draw whose axis ``dim`` runs over the
    batch, as this rank's rows of the draw a one-process run makes for the
    global batch: ``draw`` is called for every data share's rows, and the
    ranks of data index i keep rows [i·b, (i+1)·b). The shares are equal
    batches of b rows, the global batch their concatenation in order; the
    ranks of a space group draw the same rows."""
    w = data_size()
    if w == 1:
        return draw(tuple(shape))
    shape = list(shape)
    b = shape[dim]
    shape[dim] = b * w
    return draw(tuple(shape)).narrow(dim, data_rank() * b, b)


def _host_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return t.view(torch.uint8).numpy().tobytes()


def state_checksum(module: torch.nn.Module) -> int:
    """crc32 over the names and bytes of every parameter and buffer of
    ``module`` (its ``state_dict``)."""
    crc = 0
    for name, value in module.state_dict().items():
        crc = zlib.crc32(name.encode(), crc)
        if isinstance(value, torch.Tensor):
            crc = zlib.crc32(_host_bytes(value), crc)
    return crc


def verify_state_consistency(module: torch.nn.Module) -> None:
    """Compare ``state_checksum(module)`` across the ranks (JAX:
    ``engine/state.py::_verify_state_consistency``) and raise where any
    rank differs: ranks that initialized or restored other weights would
    otherwise go on with their own copies, or, under DDP, be overwritten
    by rank 0's without a word. Nothing to compare in one process."""
    w = world_size()
    if w == 1:
        return
    crc = state_checksum(module)
    mine = torch.tensor([crc], dtype=torch.int64)
    every = [torch.zeros(1, dtype=torch.int64) for _ in range(w)]
    dist.all_gather(every, mine, group=gloo_group())
    every = [int(t) for t in every]
    if any(c != crc for c in every):
        raise RuntimeError(
            "train-state checksum differs across ranks ("
            + ", ".join(f"rank {r}: {c:#010x}" for r, c in enumerate(every))
            + "): the ranks initialized or restored different weights")


def all_gather_unaligned(*arrays):
    """Every rank's rows of ``arrays`` (numpy, the same leading length on a
    rank), concatenated in rank order: the row counts are gathered, each
    array padded to the largest, gathered over the gloo group and cut back
    to each rank's real rows (reference: ``all_gather_unaligned``,
    distributed.py:155-255; JAX: ``engine/test.py::gather_across_hosts``).
    A rank of space index above 0 adds no rows: its space group's index 0
    holds the same. The identity in one process."""
    w = world_size()
    if w == 1:
        return arrays
    group = gloo_group()
    if not counts_rows():
        arrays = tuple(np.asarray(a)[:0] for a in arrays)
    n = int(np.shape(arrays[0])[0])
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(w)]
    dist.all_gather(counts, torch.tensor([n], dtype=torch.int64), group=group)
    counts = [int(c) for c in counts]
    m = max(counts)
    out = []
    for a in arrays:
        a = np.asarray(a)
        assert a.shape[0] == n, (a.shape, n)
        flag = a.dtype == np.bool_
        src = a.astype(np.uint8) if flag else a
        padded = np.zeros((m,) + a.shape[1:], src.dtype)
        padded[:n] = src
        t = torch.from_numpy(padded)
        parts = [torch.empty_like(t) for _ in range(w)]
        if t.numel():
            dist.all_gather(parts, t, group=group)
        rows = np.concatenate([p.numpy()[:c] for p, c in zip(parts, counts)])
        out.append(rows.astype(np.bool_) if flag else rows)
    return tuple(out)
