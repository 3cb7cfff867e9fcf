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
  and the eval rows (``all_gather_unaligned``).

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
    global _gloo
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
    world = cfg.NUM_SHARDS * cfg.NUM_GPUS
    dist.init_process_group(
        backend, init_method=init_method, world_size=world,
        rank=cfg.SHARD_ID * cfg.NUM_GPUS + local_rank, timeout=_timeout())
    _gloo = (dist.new_group(backend="gloo", timeout=_timeout())
             if backend != "gloo" else dist.group.WORLD)


def destroy_distributed() -> None:
    """Leave the process group, where one is up."""
    global _gloo
    if initialized():
        dist.destroy_process_group()
    _gloo = None


def gloo_group():
    """The gloo group of the run: host tensors, barriers, checksums (the
    default group where ``init_distributed`` did not make the run's)."""
    return dist.group.WORLD if _gloo is None else _gloo


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


def global_rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int],
                dim: int = 0) -> torch.Tensor:
    """``draw(shape)``, a random draw whose axis ``dim`` runs over the
    batch, as this rank's rows of the draw a one-process run makes for the
    global batch: ``draw`` is called for every rank's rows, and rank r
    keeps rows [r·b, (r+1)·b). Ranks hold equal batches of b rows, the
    global batch their concatenation in rank order."""
    w = world_size()
    if w == 1:
        return draw(tuple(shape))
    shape = list(shape)
    b = shape[dim]
    shape[dim] = b * w
    return draw(tuple(shape)).narrow(dim, rank() * b, b)


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
    The identity in one process."""
    w = world_size()
    if w == 1:
        return arrays
    group = gloo_group()
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
