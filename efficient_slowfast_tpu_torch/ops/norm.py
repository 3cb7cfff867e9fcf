"""Batch normalization (port of ``ops/norm.py:37-66`` and ``get_norm``).

Torch's own ``nn.BatchNorm3d`` is the reference's layer, so the port keeps it:
eps 1e-5, momentum 0.1 in torch's convention (new = (1-m)*old + m*batch; the
JAX package stores flax momentum 1-m), and torch computes the stable
two-pass variance the JAX package asks flax for. Parameters and running
statistics stay float32 while the activations run in the compute dtype.

Only ``BN.NORM_TYPE == "batchnorm"`` is ported; sync- and sub-batchnorm come
with the distribution slice.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn


class BatchNorm3d(nn.BatchNorm3d):
    """BN over (B, T, H, W) of an NCDHW tensor; float32 statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, zero_init_gamma: bool = False,
                 device=None):
        self.zero_init_gamma = zero_init_gamma
        super().__init__(num_features, eps=eps, momentum=momentum,
                         device=device)

    def reset_parameters(self) -> None:
        super().reset_parameters()
        if self.zero_init_gamma:
            nn.init.zeros_(self.weight)


def get_norm(cfg):
    """Norm-module factory from config (reference: batchnorm_helper.py:15-34)."""
    if cfg.BN.NORM_TYPE == "batchnorm":
        return functools.partial(BatchNorm3d, eps=cfg.BN.EPSILON,
                                 momentum=cfg.BN.MOMENTUM)
    raise NotImplementedError(
        f"BN.NORM_TYPE {cfg.BN.NORM_TYPE!r} is not ported to PyTorch yet "
        "(ROADMAP: distribution — SyncBatchNorm3d and SubBatchNorm3d)")
