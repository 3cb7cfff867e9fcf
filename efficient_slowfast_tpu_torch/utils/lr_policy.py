"""Learning-rate policies (port of ``utils/lr_policy.py``; reference:
slowfast/utils/lr_policy.py:9-86).

Pure functions of (cfg, epoch as a float), evaluated on the host once a
step: the step sets the value on its optimizer's parameter groups.
"""

from __future__ import annotations

import math


def get_lr_at_epoch(cfg, cur_epoch):
    """Policy LR with linear warmup (reference: lr_policy.py:9-27)."""
    lr = get_lr_func(cfg.SOLVER.LR_POLICY)(cfg, cur_epoch)
    if cur_epoch < cfg.SOLVER.WARMUP_EPOCHS:
        lr_start = cfg.SOLVER.WARMUP_START_LR
        lr_end = get_lr_func(cfg.SOLVER.LR_POLICY)(cfg, cfg.SOLVER.WARMUP_EPOCHS)
        alpha = (lr_end - lr_start) / cfg.SOLVER.WARMUP_EPOCHS
        lr = cur_epoch * alpha + lr_start
    return lr


def lr_func_cosine(cfg, cur_epoch):
    """Half-period cosine decay (reference: lr_policy.py:30-45)."""
    return (
        cfg.SOLVER.BASE_LR
        * (math.cos(math.pi * cur_epoch / cfg.SOLVER.MAX_EPOCH) + 1.0)
        * 0.5
    )


def lr_func_steps_with_relative_lrs(cfg, cur_epoch):
    """Stepwise LR from SOLVER.LRS at SOLVER.STEPS (reference: :48-58)."""
    ind = get_step_index(cfg, cur_epoch)
    return cfg.SOLVER.LRS[ind] * cfg.SOLVER.BASE_LR


def get_step_index(cfg, cur_epoch):
    steps = list(cfg.SOLVER.STEPS) + [cfg.SOLVER.MAX_EPOCH]
    for ind, step in enumerate(steps):
        if cur_epoch < step:
            break
    return ind - 1


def get_lr_func(policy: str):
    fn = globals().get("lr_func_" + policy)
    if fn is None:
        raise NotImplementedError(f"Unknown LR policy: {policy}")
    return fn
