"""Profiling hooks (port of ``utils/profiler.py``; the reference has no
profiler integration).

``trace`` records the enclosed block with ``torch.profiler`` (the host's
ops and, where there is a card, its kernels and copies) and writes a
Chrome trace (``chrome://tracing``, Perfetto); ``annotate`` names a span
in it; ``device_memory_profile`` dumps the card's allocator state.
"""

from __future__ import annotations

import contextlib
import os
import pickle

import torch
from torch.profiler import ProfilerActivity

from .logging import get_logger

logger = get_logger(__name__)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block into ``log_dir/trace.json``, each op with
    its input shapes; yields the ``torch.profiler.profile``
    (``key_averages()`` once the block ends)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                record_shapes=True) as prof:
        yield prof
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info("Profiler trace written to %s", path)


def annotate(name: str):
    """A named span of the trace's timeline."""
    return torch.profiler.record_function(name)


def device_memory_profile(path: str):
    """The card's allocator state (``torch.cuda.memory._snapshot``: its
    segments and blocks, and the allocations' stacks where
    ``torch.cuda.memory._record_memory_history`` is on), pickled to
    ``path``; ``torch.cuda.memory``'s viewer reads it."""
    with open(path, "wb") as f:
        pickle.dump(torch.cuda.memory._snapshot(), f)
    logger.info("Device memory profile at %s", path)
