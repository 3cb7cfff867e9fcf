"""3-D convolution and linear layers (port of ``ops/conv.py:333-446``).

Activations are NCDHW tensors kept in ``torch.channels_last_3d`` memory
format, so cuDNN takes its NDHWC path. Padding is torch-style symmetric
integers; the conv weight starts from the reference's MSRA fan-out normal
init (reference: slowfast/models/weight_init_helper.py:10-43) and the linear
layer from normal(std=fc_init_std) with a zero bias.

Each layer computes in its ``dtype`` (the cfg's compute dtype) while its
parameters stay float32, as the JAX package keeps ``param_dtype`` float32.

``TPU.TAP_DECOMPOSE`` and ``TPU.STEM_D2S`` are exact rewrites of the same
conv for the TPU; here they run the plain conv. The int8 serving branches
(``TPU.INT8_EVAL``, ``TPU.INT8_SPATIAL``) are not ported yet.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def check_options(cfg) -> None:
    """Refuse the conv options this package does not implement."""
    if cfg.TPU.INT8_EVAL or cfg.TPU.INT8_SPATIAL:
        raise NotImplementedError(
            "TPU.INT8_EVAL / TPU.INT8_SPATIAL are not ported to PyTorch yet "
            "(ROADMAP: serving and tools)")


def _triple(v) -> tuple:
    if isinstance(v, (tuple, list)):
        assert len(v) == 3
        return tuple(int(x) for x in v)
    return (int(v),) * 3


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` with MSRA fan-out init that computes in ``dtype``."""

    def __init__(self, dim_in: int, dim_out: int,
                 kernel_size: Sequence[int] | int,
                 stride: Sequence[int] | int = 1,
                 padding: Sequence[int] | int = 0,
                 groups: int = 1, bias: bool = False,
                 dilation: Sequence[int] | int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        self.compute_dtype = dtype
        super().__init__(dim_in, dim_out, _triple(kernel_size),
                         _triple(stride), _triple(padding), _triple(dilation),
                         groups, bias, device=device)

    def reset_parameters(self) -> None:
        kt, kh, kw = self.kernel_size
        fan_out = self.out_channels * kt * kh * kw // self.groups
        nn.init.normal_(self.weight, 0.0, math.sqrt(2.0 / fan_out))
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.conv3d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class Linear(nn.Linear):
    """``nn.Linear`` with the reference's fc init that computes in ``dtype``."""

    def __init__(self, dim_in: int, dim_out: int, init_std: float = 0.01,
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None):
        self.init_std = init_std
        self.compute_dtype = dtype
        super().__init__(dim_in, dim_out, bias, device=device)

    def reset_parameters(self) -> None:
        nn.init.normal_(self.weight, 0.0, self.init_std)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), bias)
