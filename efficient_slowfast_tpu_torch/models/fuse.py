"""Lateral pathway fusion.

- FuseFastToSlow (reference: video_model_builder.py:93-150): strided
  temporal conv on the fast pathway, BN, ReLU, then concatenated onto the
  slow pathway's channels.
- FuseFastAndSlow (reference: custom_video_model_builder.py:42-148): the
  CMDA bidirectional dual-attention fusion, the paper's contribution.
  Fast→Slow = temporal max-pool(α) → ECA → BN → ReLU → concat[slow, f2s];
  Slow→Fast = 1×1×1 conv (C → C/β) → SpatialAttention → BN → ReLU →
  nearest temporal upsample(α) → concat[s2f, fast] (slow-derived channels
  first).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import ECA, SpatialAttention
from ..ops.conv import Conv3d
from ..ops.norm import BatchNorm3d
from ..ops.pool import temporal_downsample_max, temporal_upsample_nearest


def _cat(xs):
    return torch.cat(xs, dim=1).contiguous(memory_format=torch.channels_last_3d)


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
        return [_cat([x_s, fuse.to(x_s.dtype)]), x_f]


class FuseFastAndSlow(nn.Module):
    """CMDA bidirectional fusion with channel and spatial attention.

    ``dim_slow`` and ``dim_fast`` are the channels of the two pathways that
    come in; the slow pathway leaves with ``dim_slow + dim_fast`` and the
    fast one with ``dim_slow // beta_inv + dim_fast``. ``use_flash`` and
    ``flash_min_tokens`` go to the SpatialAttention (``TPU.FLASH_*``).
    """

    def __init__(self, dim_slow: int, dim_fast: int, alpha: int,
                 beta_inv: int, reduction: int = 1,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32, use_flash: bool = True,
                 flash_min_tokens: int = 1024):
        super().__init__()
        self.alpha = alpha
        dim_s2f = dim_slow // beta_inv
        self.attention_channel_f2s = ECA()
        self.bn_f2s = norm(dim_fast)
        self.downsample_c_of_slow = Conv3d(dim_slow, dim_s2f, 1, dtype=dtype)
        self.attention_spatial_s2f = SpatialAttention(
            dim_s2f, reduction=reduction, use_flash=use_flash,
            flash_min_tokens=flash_min_tokens, dtype=dtype)
        self.bn_s2f = norm(dim_s2f)

    def forward(self, x):
        x_s, x_f = x
        # Fast → Slow: squeeze time, gate channels.
        f2s = temporal_downsample_max(x_f, self.alpha)
        f2s = F.relu(self.bn_f2s(self.attention_channel_f2s(f2s)))
        # Slow → Fast: squeeze channels, attend space-time, expand time.
        s2f = self.attention_spatial_s2f(self.downsample_c_of_slow(x_s))
        s2f = temporal_upsample_nearest(F.relu(self.bn_s2f(s2f)), self.alpha)
        return [_cat([x_s, f2s.to(x_s.dtype)]), _cat([s2f.to(x_f.dtype), x_f])]
