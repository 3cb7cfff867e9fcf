"""Batch normalization (port of ``ops/norm.py:37-66`` and ``get_norm``).

The JAX package wraps ``flax.linen.BatchNorm`` (momentum 1-m, two-pass
variance); the port keeps torch's ``nn.BatchNorm3d`` (the reference's
layer), with eps 1e-5 and momentum m in torch's convention, new = (1-m)*old
+ m*batch. Parameters and running statistics stay float32 while the
activations run in the compute dtype.

- Eval: the running statistics, as ``nn.BatchNorm3d``.
- Train: the batch statistics over (B, T, H, W), computed in float32 from
  the activations (bf16 ones included) and normalising with the biased
  variance, as both frameworks do. The running variance is where they part:
  torch updates it with the unbiased batch variance, n/(n-1) times the
  biased one, flax with the biased one. The port updates it as flax does,
  under ``no_grad``: torch's fused update, then the exact correction
  new·(n-1)/n + old·(1-m)/n, so that new = (1-m)·old + m·biased.
- ``update_stats`` False normalises with the batch statistics and leaves the
  running ones as they are: a rematerialised stage's recompute runs its
  BN a second time, and flax's ``nn.remat`` updates ``batch_stats`` once.

Only ``BN.NORM_TYPE == "batchnorm"`` is ported; sync- and sub-batchnorm come
with the distribution slice.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm3d(nn.BatchNorm3d):
    """BN over (B, T, H, W) of an NCDHW tensor; float32 statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, zero_init_gamma: bool = False,
                 device=None):
        self.zero_init_gamma = zero_init_gamma
        super().__init__(num_features, eps=eps, momentum=momentum,
                         device=device)
        self.update_stats = True

    def reset_parameters(self) -> None:
        super().reset_parameters()
        if self.zero_init_gamma:
            nn.init.zeros_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # copies: autograd keeps the statistics it was given, which must
        # not change before the backward; the recompute of a remat stage
        # runs the same op (the checkpoint checks that it saves the same
        # tensors) and drops its update
        m = self.momentum
        n = x.numel() // x.shape[1]
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, m,
                         self.eps)
        if self.update_stats:
            with torch.no_grad():  # unbiased → biased batch variance
                self.running_mean.copy_(mean)
                self.running_var.mul_((1 - m) / n).add_(var,
                                                         alpha=(n - 1) / n)
                self.num_batches_tracked += 1
        return y


def get_norm(cfg):
    """Norm-module factory from config (reference: batchnorm_helper.py:15-34)."""
    if cfg.BN.NORM_TYPE == "batchnorm":
        return functools.partial(BatchNorm3d, eps=cfg.BN.EPSILON,
                                 momentum=cfg.BN.MOMENTUM)
    raise NotImplementedError(
        f"BN.NORM_TYPE {cfg.BN.NORM_TYPE!r} is not ported to PyTorch yet "
        "(ROADMAP: distribution — SyncBatchNorm3d and SubBatchNorm3d)")
