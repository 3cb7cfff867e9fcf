"""Inference forward (port of ``engine/state.py:222-245``, ``make_forward``).

The train state, train and eval steps come with the train-step slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.build import get_compute_dtype, resolve_device


def make_forward(cfg, model: torch.nn.Module, device=None) -> Callable:
    """Eval forward: fn([slow, fast]) → scores, under ``inference_mode``.

    ``device`` defaults to the GPU (and raises where there is none); the
    model is moved there and put in eval mode, and inputs are moved there
    and cast to the compute dtype. ``cfg.TPU.FUSED_EVAL`` selects the fused
    serving engine (folded BN + the fused bottleneck kernel,
    engine/inference.py) when the config is inside its envelope; otherwise
    the module's own forward runs.
    """
    dev = resolve_device(device)
    dtype = get_compute_dtype(cfg)
    model = model.to(dev).eval()
    fwd = model
    if cfg.TPU.FUSED_EVAL:
        # the fused engine never calls the module, so it cannot serve the
        # int8 path — refuse rather than silently serving fp as "int8"
        assert not cfg.TPU.INT8_EVAL, (
            "TPU.FUSED_EVAL and TPU.INT8_EVAL are mutually exclusive")
        from .inference import make_fused_eval_forward, supports

        if supports(cfg):
            fwd = make_fused_eval_forward(cfg, model)

    def forward(inputs):
        with torch.inference_mode():
            return fwd([x.to(dev, dtype, non_blocking=True) for x in inputs])

    return forward
