"""Logging utilities (reference: slowfast/utils/logging.py:18-96).

Master-process-only stdout + file logging. The master is
``torch.distributed`` rank 0 when a process group is up, else the one
process there is.
"""

from __future__ import annotations

import logging
import os
import sys

import torch.distributed as dist

_LOGGER_INITIALIZED = False


def is_master() -> bool:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def setup_logging(output_dir: str | None = None) -> None:
    """Configure root logger: stdout + optional ``output_dir/stdout.log``."""
    global _LOGGER_INITIALIZED
    if _LOGGER_INITIALIZED:
        return
    _LOGGER_INITIALIZED = True

    master = is_master()
    logger = logging.getLogger()
    logger.setLevel(logging.INFO if master else logging.ERROR)
    for h in list(logger.handlers):
        logger.removeHandler(h)
    if not master:
        return
    fmt = logging.Formatter(
        "[%(asctime)s][%(levelname)s] %(name)s: %(lineno)4d: %(message)s",
        datefmt="%m/%d %H:%M:%S",
    )
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "stdout.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)

