"""CLI arguments and config loading (port of ``config/parser.py``;
reference: slowfast/utils/parser.py:13-94).

The port's CLI adds one flag to the JAX package's, ``--device``: the
torch device to run on (the GPU unless it is given). It is not a config
key. ``--shard_id``, ``--num_shards`` and ``--init_method`` place this
machine's processes in the job (``utils/misc.py::launch_job``).
"""

from __future__ import annotations

import argparse
import os
import sys
import types

from . import load_cfg
from .node import CfgNode


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Efficient-SlowFast train/test pipeline on PyTorch/CUDA."
    )
    parser.add_argument(
        "--shard_id", type=int, default=0,
        help="Shard id (machine index) of this node; 0 .. NUM_SHARDS-1.",
    )
    parser.add_argument(
        "--num_shards", type=int, default=1,
        help="Number of machines in the job."
    )
    parser.add_argument(
        "--init_method", type=str, default="tcp://localhost:9999",
        help="Rendezvous address of a multi-process job (machine 0's).",
    )
    parser.add_argument(
        "--cfg", dest="cfg_file", type=str, default=None, help="Path to config yaml."
    )
    parser.add_argument(
        "--device", type=str, default=None,
        help="torch device to run on (e.g. cpu); the GPU when not given.",
    )
    parser.add_argument(
        "opts", nargs=argparse.REMAINDER, default=None,
        help="KEY VALUE override pairs appended after the flags.",
    )
    if argv is None and len(sys.argv) == 1:
        parser.print_help()
    return parser.parse_args(argv)


def load_config(args) -> CfgNode:
    """Build the job config: defaults < yaml < CLI opts (reference:
    parser.py:67-94); makes OUTPUT_DIR/checkpoints."""
    cfg = load_cfg(getattr(args, "cfg_file", None),
                   getattr(args, "opts", None))
    if hasattr(args, "num_shards") and hasattr(args, "shard_id"):
        cfg.NUM_SHARDS = args.num_shards
        cfg.SHARD_ID = args.shard_id
    if cfg.OUTPUT_DIR:
        os.makedirs(os.path.join(cfg.OUTPUT_DIR, "checkpoints"), exist_ok=True)
    return cfg


def load_config_from(cfg_file: str, opts=None) -> CfgNode:
    """``load_config`` for tools with their own argument parser."""
    return load_config(types.SimpleNamespace(cfg_file=cfg_file, opts=opts))
