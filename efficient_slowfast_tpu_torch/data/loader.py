"""Host feeder: batching, threaded prefetch and the host→GPU copy (port of
``data/loader.py``).

Replaces the reference's torch DataLoader worker processes and
DistributedSampler (reference: slowfast/datasets/loader.py:55-137) with:

- per-process index sharding by the ``torch.distributed`` rank and world
  size (0 and 1 when no process group is up);
- a thread pool pasting samples straight into the batch's canvas array, a
  bounded queue ahead of the consumer;
- ``prefetch_to_device``: a ring of pinned host canvases that the threads
  fill and a side stream copies to the card, the next batches' copies in
  flight while the current batch computes.

The per-epoch shuffle is seeded (epoch, RNG_SEED) like
``loader.shuffle_dataset → sampler.set_epoch`` (reference: loader.py:119-137)
and draws the JAX package's order.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..parallel import distributed
from ..utils.meters import span
from ..utils.multigrid import short_cycle_batch_sizes
from .build import build_dataset
from .datasets import CanvasDataset


def process_rank_and_count() -> tuple:
    """(rank, world size) of this process: the process group's when one
    is up, else (0, 1)."""
    return distributed.rank(), distributed.world_size()


def shard_indices(indices: np.ndarray, process_count: int,
                  process_index: int) -> tuple:
    """Split a global sample order across processes; never silently drops
    data.

    Every process receives exactly ``ceil(n / process_count)`` indices so
    all run the same number of steps (their collectives would hang
    otherwise). When ``n % process_count != 0`` the order is wrap-padded
    with its head (the reference DistributedSampler's policy,
    reference: slowfast/datasets/loader.py:104) and assigned round-robin,
    so each process's duplicates land at the TAIL of its list. Returns
    ``(indices, n_valid)`` where positions ``>= n_valid`` are the wrapped
    duplicates — eval masks them out so no sample is counted twice.
    """
    indices = np.asarray(indices)
    n = len(indices)
    pc = max(int(process_count), 1)
    pi = int(process_index)
    assert 0 <= pi < pc, (pi, pc)
    if pc == 1:
        return indices, n
    assert n > 0, "cannot shard an empty dataset"
    per = -(-n // pc)  # ceil
    # tile (np.resize) so padding works even when n < pc
    padded = np.resize(indices, per * pc)
    host = padded[pi::pc]
    # process pi holds global positions {pi + k*pc}; positions >= n are the
    # wrapped duplicates, and since positions increase with k they form
    # the TAIL of its list
    n_valid = max(0, -(-(n - pi) // pc)) if pi < n else 0
    return host, n_valid


def construct_loader(cfg, split: str):
    """The split's ClipLoader. The config's batch sizes are global, over
    every process of the run: each process takes its share, the batch size
    divided by the world size (a train batch must divide; an eval share
    rounds up, its padding masked by ``_valid``)."""
    assert split in ("train", "val", "test")
    _, world = process_rank_and_count()
    schedule = None
    if split == "train":
        dataset_name = cfg.TRAIN.DATASET
        batch_size = cfg.TRAIN.BATCH_SIZE
        shuffle, drop_last, pad_to_full = True, True, False
        if batch_size % world:
            raise ValueError(
                f"TRAIN.BATCH_SIZE ({batch_size}) must be divisible by the "
                f"world size ({world})")
        if cfg.MULTIGRID.SHORT_CYCLE:
            # the short cycle's batch sizes, step by step
            schedule = [b // world for b in short_cycle_batch_sizes(cfg)]
    elif split == "val":
        dataset_name = cfg.TRAIN.DATASET
        batch_size = cfg.TRAIN.BATCH_SIZE
        shuffle, drop_last, pad_to_full = False, False, True
    else:
        dataset_name = cfg.TEST.DATASET
        batch_size = cfg.TEST.BATCH_SIZE
        shuffle, drop_last, pad_to_full = False, False, True
    return ClipLoader(
        build_dataset(dataset_name, cfg, split),
        batch_size=-(-batch_size // world),
        shuffle=shuffle,
        drop_last=drop_last,
        num_workers=cfg.DATA_LOADER.NUM_WORKERS,
        prefetch=cfg.DATA_LOADER.PREFETCH_DEPTH,
        seed=cfg.RNG_SEED,
        batch_size_schedule=schedule,
        pad_to_full=pad_to_full,
    )


class ClipLoader:
    """Iterable over collated numpy batches with background decode threads."""

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False,
                 num_workers=4, prefetch=2, seed=0, batch_size_schedule=None,
                 pad_to_full=False):
        self.dataset = dataset
        self.batch_size = max(1, batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        # short-cycle: batch sizes cycled per iteration
        # (reference: datasets/multigrid_helper.py ShortCycleBatchSampler)
        self.batch_size_schedule = batch_size_schedule
        # pad every batch to exactly `batch_size` samples (repeating the last
        # index) and emit a `_valid` {1,0} mask — one batch shape for every
        # batch while never dropping eval samples
        self.pad_to_full = pad_to_full
        self._epoch = 0
        self.pinned_ring: Optional[PinnedRing] = None  # prefetch_to_device's

    @property
    def max_batch_size(self) -> int:
        """The largest batch the loader yields."""
        return max(self.batch_size_schedule or [self.batch_size])

    def set_epoch(self, epoch: int):
        """reference: loader.shuffle_dataset → sampler.set_epoch; the
        dataset's per-item draws follow the epoch too."""
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.dataset)
        n = -(-n // process_rank_and_count()[1])  # this process's share
        if self.batch_size_schedule:
            return len(self._schedule_batches(np.arange(n)))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _schedule_batches(self, indices):
        """Split indices into batches following the cycling size schedule;
        each batch carries its phase index as `_phase`."""
        batches = []
        pos = 0
        i = 0
        sched = self.batch_size_schedule
        while pos < len(indices):
            bs = sched[i % len(sched)]
            chunk = indices[pos: pos + bs]
            if len(chunk) < bs and self.drop_last:
                break
            batches.append((i % len(sched), chunk))
            pos += bs
            i += 1
        return batches

    def _indices(self) -> tuple:
        """This process's (indices, n_valid); positions >= n_valid are
        wrap-padding."""
        n = len(self.dataset)
        idx = np.arange(n)
        weights = getattr(self.dataset, "sample_weights", None)
        if self.shuffle and weights is not None:
            # weighted random sampling with replacement
            # (reference: MODEL.WEIGHTED_RANDOM_SAMPLER, custom_config.py)
            rs = np.random.RandomState(self.seed + self._epoch)
            p = np.asarray(weights, np.float64)
            idx = rs.choice(n, size=n, replace=True, p=p / p.sum())
        elif self.shuffle:
            rs = np.random.RandomState(self.seed + self._epoch)
            rs.shuffle(idx)
        rank, world = process_rank_and_count()
        return shard_indices(idx, world, rank)

    def _fill(self):
        """The dataset's ``getitem_into`` where it may be used: where it
        has one (a clip or frame-list dataset, AVA), and a clip or
        frame-list dataset only when it does not override ``__getitem__``,
        which the preallocated path would bypass."""
        own = type(self.dataset).__getitem__
        if isinstance(self.dataset, CanvasDataset) and (
                own is not CanvasDataset.__getitem__):
            return None
        return getattr(self.dataset, "getitem_into", None)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.batches()

    def batches(self, frames_alloc=None) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's batches. ``frames_alloc(shape, stop)``, where given,
        supplies each batch's frames array on the preallocated path as
        ``(array, slot)`` (``slot`` rides the batch as ``_slot``), or None
        once the ``stop`` event is set."""
        indices, n_valid = self._indices()
        # wrap-padded duplicates of other processes sit at the tail
        sample_valid = np.arange(len(indices)) < n_valid
        if self.batch_size_schedule:
            batches = [(ph, chunk, np.ones(len(chunk), bool))
                       for ph, chunk in self._schedule_batches(indices)]
        else:
            nb = len(indices) // self.batch_size
            if not self.drop_last and len(indices) % self.batch_size:
                nb += 1
            batches = [
                (None,
                 indices[i * self.batch_size:(i + 1) * self.batch_size],
                 sample_valid[i * self.batch_size:(i + 1) * self.batch_size])
                for i in range(nb)
            ]
        if not batches:
            return

        out_q: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        fill = self._fill()

        def produce():
            try:
                for phase, batch_idx, batch_valid in batches:
                    if stop.is_set():
                        return
                    n_real = len(batch_idx)
                    if self.pad_to_full and n_real < self.batch_size:
                        pad = np.full(self.batch_size - n_real, batch_idx[-1])
                        batch_idx = np.concatenate([batch_idx, pad])
                    if fill is not None:
                        shape = (len(batch_idx),) + self.dataset.frames_shape()
                        slot = None
                        if frames_alloc is None:
                            frames = np.empty(shape, np.uint8)
                        else:
                            got = frames_alloc(shape, stop)
                            if got is None:
                                return
                            frames, slot = got
                        scalars = list(pool.map(
                            lambda ji: fill(int(ji[1]), frames[ji[0]]),
                            enumerate(batch_idx)))
                        collated = _collate(scalars)
                        collated["frames"] = frames
                        if slot is not None:
                            collated["_slot"] = slot
                    else:
                        samples = list(
                            pool.map(lambda i: self.dataset[int(i)], batch_idx)
                        )
                        collated = _collate(samples)
                    if self.pad_to_full:
                        # invalid = batch-tail padding OR other processes'
                        # wrap duplicates
                        mask = np.zeros(len(batch_idx), np.float32)
                        mask[:n_real] = batch_valid.astype(np.float32)
                        collated["_valid"] = mask
                    if phase is not None:
                        collated["_phase"] = np.int32(phase)
                    out_q.put(("batch", collated))
            except BaseException as exc:  # propagate to the consumer thread
                out_q.put(("error", exc))
            finally:
                out_q.put(None)
                pool.shutdown(wait=True)  # its threads end with the producer

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                kind, payload = item
                if kind == "error":
                    raise payload
                yield payload
        finally:
            stop.set()
            _drain_queue(out_q, t)


def _drain_queue(q, thread) -> None:
    """Unblock a producer stuck in q.put() after a consumer early-exit and
    wait for it to end.

    Without this, breaking out of the iterator leaves the producer thread
    blocked forever on the full queue (leaking the worker pool plus the
    prefetched frame batches it holds).
    """
    while thread.is_alive():
        try:
            q.get_nowait()
        except queue.Empty:
            thread.join(timeout=0.05)


def _collate(samples) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0].keys():
        out[k] = np.stack([s[k] for s in samples])
    return out


def shuffle_dataset(loader: ClipLoader, cur_epoch: int):
    """reference: loader.py:119-137."""
    loader.set_epoch(cur_epoch)


class PinnedRing:
    """Page-locked host canvases that a loader's threads fill and the card
    copies from.

    A slot is handed out (``acquire``) only when it is free and the copy
    that last read it (its event) has completed; the copying side gives
    it back with that copy's event (``release``). The buffers live as long
    as the ring, so the page-locking is paid once, not once a batch. Each
    slot holds ``shape``, the loader's largest batch; a smaller batch (a
    short cycle's) takes its leading rows.
    """

    def __init__(self, shape, slots: int):
        self.shape = tuple(shape)
        self._host = [torch.empty(self.shape, dtype=torch.uint8,
                                  pin_memory=True) for _ in range(slots)]
        self._rows = [0] * slots
        self._events = [None] * slots
        self._busy = [False] * slots
        self._cond = threading.Condition()

    def reset(self):
        """Every slot free (their last copies still awaited by acquire)."""
        with self._cond:
            self._busy = [False] * len(self._busy)
            self._cond.notify_all()

    def acquire(self, shape, stop: threading.Event):
        """(numpy view of the first ``shape[0]`` rows of a free slot, its
        index), or None once ``stop`` is set."""
        shape = tuple(shape)
        assert shape[1:] == self.shape[1:] and shape[0] <= self.shape[0], (
            shape, self.shape)
        with self._cond:
            while True:
                if stop.is_set():
                    return None
                free = [i for i, b in enumerate(self._busy) if not b]
                if free:
                    i = free[0]
                    self._busy[i] = True
                    break
                self._cond.wait(timeout=0.05)
        if self._events[i] is not None:
            self._events[i].synchronize()
        self._rows[i] = shape[0]
        return self._host[i][:shape[0]].numpy(), i

    def tensor(self, slot: int) -> torch.Tensor:
        """The rows of ``slot`` that its last ``acquire`` handed out."""
        return self._host[slot][:self._rows[slot]]

    def release(self, slot: int, event):
        with self._cond:
            self._events[slot] = event
            self._busy[slot] = False
            self._cond.notify_all()


def _as_tensor(value):
    return torch.from_numpy(np.asarray(value))


def prefetch_to_device(loader: ClipLoader, device, depth: int = 2,
                       times=None):
    """Iterate ``loader`` with each batch's frames on ``device`` and every
    other array on the host as a CPU tensor (clip ids, labels, masks: what
    the host needs stays there, with no read-back).

    On a CUDA device a copy thread takes each batch as the loader's
    threads finish it, in pinned memory (the loader's ``PinnedRing``, one
    slot for each batch the loader may hold plus two), and copies it with
    ``non_blocking`` on a side stream; up to ``depth`` batches wait copied
    ahead of the consumer, whose stream waits on each copy's event. The
    ring needs the dataset's fill path and full batches (a short cycle's
    sizes at most its slots'), as every loader of ``construct_loader`` has;
    another loader raises. On the CPU the
    arrays are wrapped without a copy. ``times``
    (``utils.meters.StageTimes``), where given, gets the seconds the
    consumer waits for each batch and each copy's span.
    """
    dev = torch.device(device)
    if dev.type != "cuda":
        batches = loader.batches()
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if times is not None:
                    times.waits.append(time.perf_counter() - t0)
                if batch is None:
                    return
                yield {k: _as_tensor(v) for k, v in batch.items()}
        finally:
            batches.close()

    # full batches (eval pads its tail, train drops it) and the dataset's
    # fill path: what the pinned ring needs, and what every loader of
    # construct_loader has
    if loader._fill() is None or not (loader.pad_to_full or loader.drop_last):
        raise ValueError("prefetch_to_device on CUDA needs a loader with the "
                         "preallocated fill path and full batches "
                         "(pad_to_full or drop_last)")
    shape = (loader.max_batch_size,) + loader.dataset.frames_shape()
    if loader.pinned_ring is None or loader.pinned_ring.shape != shape:
        loader.pinned_ring = PinnedRing(shape, loader.prefetch + 2)
    ring = loader.pinned_ring
    ring.reset()
    side = torch.cuda.Stream(dev)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def copy():
        batches = loader.batches(ring.acquire)
        try:
            with torch.cuda.device(dev), torch.cuda.stream(side):
                for batch in batches:
                    if stop.is_set():
                        return
                    slot = batch.pop("_slot")
                    del batch["frames"]  # the slot's view
                    out = {k: _as_tensor(v) for k, v in batch.items()}
                    with span(times, "copy", dev, side):
                        out["frames"] = ring.tensor(slot).to(
                            dev, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(side)
                    ring.release(slot, done)
                    q.put(("batch", (out, done)))
        except BaseException as exc:  # propagate to the consumer thread
            q.put(("error", exc))
        finally:
            batches.close()
            q.put(None)

    t = threading.Thread(target=copy, daemon=True)
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if times is not None:
                times.waits.append(time.perf_counter() - t0)
            if item is None:
                break
            kind, payload = item
            if kind == "error":
                raise payload
            out, done = payload
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(done)
            # allocated on the side stream, used on this one
            out["frames"].record_stream(stream)
            yield out
    finally:
        stop.set()
        _drain_queue(q, t)
