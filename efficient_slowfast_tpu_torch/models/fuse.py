"""Lateral fast→slow fusion (reference: video_model_builder.py:93-150).

FuseFastToSlow: strided temporal conv on the fast pathway, BN, ReLU, then
concatenated onto the slow pathway's channels. The CMDA fusion
(FuseFastAndSlow) comes with the attention slice.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Conv3d
from ..ops.norm import BatchNorm3d


class FuseFastToSlow(nn.Module):
    def __init__(self, dim_in: int, fusion_conv_channel_ratio: int,
                 fusion_kernel: int, alpha: int,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_f2s = Conv3d(
            dim_in, dim_in * fusion_conv_channel_ratio,
            (fusion_kernel, 1, 1), (alpha, 1, 1), (fusion_kernel // 2, 0, 0),
            dtype=dtype)
        self.bn = norm(dim_in * fusion_conv_channel_ratio)

    def forward(self, x):
        x_s, x_f = x
        fuse = F.relu(self.bn(self.conv_f2s(x_f)))
        cat = torch.cat([x_s, fuse.to(x_s.dtype)], dim=1)
        return [cat.contiguous(memory_format=torch.channels_last_3d), x_f]
