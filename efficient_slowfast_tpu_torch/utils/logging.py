"""Logging utilities (reference: slowfast/utils/logging.py:18-96).

Master-process-only stdout + file logging and one-line JSON stats. The
master is ``torch.distributed`` rank 0 when a process group is up, else
the one process there is.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Any, Mapping

from ..parallel.distributed import is_master  # noqa: F401 (re-exported)

_LOGGER_INITIALIZED = False


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


def log_json_stats(stats: Mapping[str, Any]) -> None:
    """One-line JSON stats record, on the master only (reference:
    logging.py:84-96)."""
    if not is_master():
        return
    stats = {
        k: (round(float(v), 5) if isinstance(v, float) else v) for k, v in stats.items()
    }
    get_logger(__name__).info("json_stats: %s", json.dumps(stats, sort_keys=True))

