"""Misc utilities (port of ``utils/misc.py``; reference: slowfast/utils/misc.py).

``launch_job`` runs the job in this process: one process, one card. The
reference spawns a process per GPU; the multi-process launch comes with
the distribution slice (ROADMAP item 7).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from .logging import get_logger

logger = get_logger(__name__)


def launch_job(cfg, init_method: str, func: Callable):
    """``func(cfg)`` in this process (reference :275-303); a run over
    several machines (``NUM_SHARDS`` > 1) raises."""
    if cfg.NUM_SHARDS > 1:
        raise NotImplementedError(
            f"NUM_SHARDS {cfg.NUM_SHARDS} (init method {init_method}): the "
            "multi-process launch comes with ROADMAP item 7")
    return func(cfg)


def check_nan_losses(loss: float):
    """reference: misc.py:26-33."""
    if math.isnan(loss):
        raise RuntimeError("ERROR: Got NaN losses")


def params_count(model: torch.nn.Module) -> int:
    """The number of parameters (reference: misc.py:36-42)."""
    return sum(p.numel() for p in model.parameters())


def gpu_mem_usage() -> float:
    """The most memory the card has held for tensors, in GiB (reference:
    misc.py:45-54); 0 without a card."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / 1024 ** 3


def cpu_mem_usage():
    """(used, total) host memory in GiB (reference: misc.py:57-68); zeros
    where ``psutil`` is missing."""
    try:
        import psutil
    except ImportError:
        return 0.0, 0.0
    vram = psutil.virtual_memory()
    return (vram.total - vram.available) / 1024 ** 3, vram.total / 1024 ** 3


def get_flop_stats(model: torch.nn.Module, example_inputs,
                   bboxes=None) -> float:
    """FLOPs of one eval forward on ``example_inputs``, counted by
    ``torch.utils.flop_counter`` (reference: fvcore's flop_count,
    misc.py:109-150). The JAX package reads XLA's cost analysis of the
    compiled program instead; the counter here counts the aten matmuls and
    convolutions as torch dispatches them, so work done inside the port's
    own CUDA kernels (the attention's) is not counted. A detection model
    takes ``bboxes``, its RoIs."""
    from torch.utils.flop_counter import FlopCounterMode

    was_training = model.training
    model.eval()
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        if bboxes is None:
            model(example_inputs)
        else:
            model(example_inputs, bboxes)
    model.train(was_training)
    return float(counter.get_total_flops())


def log_model_info(model: torch.nn.Module, cfg, example_inputs):
    """Parameters, memory and FLOPs (reference: misc.py:165-190)."""
    logger.info("Model:\n%s", type(model).__name__)
    logger.info("Params: %s", f"{params_count(model):,}")
    logger.info("Mem: %.2f GB", gpu_mem_usage())
    bboxes = None
    if cfg.DETECTION.ENABLE:  # one RoI over the first clip's whole crop
        s = float(example_inputs[0].shape[2])
        bboxes = torch.tensor([[0.0, 0.0, 0.0, s, s]],
                              device=example_inputs[0].device)
    logger.info("Flops: %.2f G",
                get_flop_stats(model, example_inputs, bboxes) / 1e9)
    used, total = cpu_mem_usage()
    logger.info("CPU mem: %.2f / %.2f GB", used, total)
