"""Optimizer construction (port of ``models/optimizer.py:19-100``;
reference: slowfast/models/optimizer.py:11-91).

SGD (momentum, nesterov) or Adam (eps 1e-8) with the reference's split
weight decay, coupled as in torch (added to the gradient before the
momentum or Adam statistics): the parameters of a BatchNorm module
(``nn.BatchNorm*``, the port's ``BatchNorm3d`` and ``SubBatchNorm3d``) take
``BN.WEIGHT_DECAY``, all others ``SOLVER.WEIGHT_DECAY``. That is the set
the JAX package's ``bn_mask`` selects by a "bn" in the parameter's path
(``s2/pathway0_res0/branch2/a_bn/bn/scale``, ``.../banch2_pw/bn/bn/scale``).
The port's names cannot stand in for those paths: the efficient families
carry the reference's ``nn.Sequential`` indices
(``s2.pathway0_channel_224.features.0.banch2.1.weight`` is a BN weight),
so the groups go by the module that owns the parameter.
``torch.optim.SGD``/``Adam`` compute optax's chain step for step
(``add_decayed_weights`` → ``trace``/``scale_by_adam`` → ``scale(-lr)``).
The learning rate is set on every group before each step (``set_lr``), as
the JAX package injects it.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.norm import SubBatchNorm3d

_BN_MODULES = (nn.modules.batchnorm._BatchNorm, SubBatchNorm3d)


def bn_param_names(model: nn.Module) -> set:
    """The names of the parameters that a BatchNorm module of ``model``
    owns (the JAX package's ``bn_mask``)."""
    return {f"{mod}.{name}" if mod else name
            for mod, m in model.named_modules()
            if isinstance(m, _BN_MODULES)
            for name, _ in m.named_parameters(recurse=False)}


def cast_moment_state(optimizer: torch.optim.Optimizer,
                      dtype: torch.dtype) -> torch.optim.Optimizer:
    """Store the optimizer's moment buffers in ``dtype``
    (``TPU.OPTIMIZER_STATE_DTYPE bfloat16`` halves their memory). The update
    still runs in float32: the buffers are upcast before each step and
    downcast after, so only the storage changes."""

    def cast(opt, to):
        for state in opt.state.values():
            for key, val in state.items():
                if (key != "step" and torch.is_tensor(val)
                        and val.is_floating_point()):
                    state[key] = val.to(to)

    optimizer.register_step_pre_hook(
        lambda opt, args, kwargs: cast(opt, torch.float32))
    optimizer.register_step_post_hook(
        lambda opt, args, kwargs: cast(opt, dtype))
    return optimizer


def construct_optimizer(cfg, model: torch.nn.Module) -> torch.optim.Optimizer:
    """The optimizer over ``model``'s parameters: two groups, the
    non-BN parameters with ``SOLVER.WEIGHT_DECAY`` and the BN ones with
    ``BN.WEIGHT_DECAY``; lr ``SOLVER.BASE_LR`` until ``set_lr``."""
    groups = [{"params": [], "weight_decay": cfg.SOLVER.WEIGHT_DECAY},
              {"params": [], "weight_decay": cfg.BN.WEIGHT_DECAY}]
    bn = bn_param_names(model)
    for name, p in model.named_parameters():
        groups[name in bn]["params"].append(p)
    groups = [g for g in groups if g["params"]]
    method, lr = cfg.SOLVER.OPTIMIZING_METHOD, cfg.SOLVER.BASE_LR
    if method == "sgd":
        assert cfg.SOLVER.DAMPENING == 0.0, "dampening != 0 unsupported"
        momentum = cfg.SOLVER.MOMENTUM
        opt = torch.optim.SGD(groups, lr=lr, momentum=momentum,
                              nesterov=bool(cfg.SOLVER.NESTEROV and momentum))
    elif method == "adam":
        opt = torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    else:
        raise NotImplementedError(f"Does not support {method} optimizer")
    dtype = {"float32": torch.float32,
             "bfloat16": torch.bfloat16}[cfg.TPU.OPTIMIZER_STATE_DTYPE]
    if dtype != torch.float32:
        cast_moment_state(opt, dtype)
    return opt


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = lr
