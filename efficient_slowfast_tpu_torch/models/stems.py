"""Input stems (reference: slowfast/models/stem_helper.py).

ResNetBasicStem (:102-178): conv(kT,7,7)/s(1,2,2) → BN → ReLU →
maxpool(1,3,3)/s(1,2,2)/p(0,1,1). VideoModelStem (:9-99) applies one stem
per pathway.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Conv3d
from ..ops.norm import BatchNorm3d
from ..ops.pool import max_pool3d


class ResNetBasicStem(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, kernel: Sequence[int],
                 stride: Sequence[int], padding: Sequence[int],
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3d(dim_in, dim_out, kernel, stride, padding,
                           dtype=dtype)
        self.bn = norm(dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(x)))
        return max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class VideoModelStem(nn.Module):
    """Per-pathway ResNetBasicStem over the list of pathway tensors."""

    def __init__(self, dim_in: Sequence[int], dim_out: Sequence[int],
                 kernel: Sequence[Sequence[int]],
                 stride: Sequence[Sequence[int]],
                 padding: Sequence[Sequence[int]],
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_pathways = len(dim_out)
        for p in range(self.num_pathways):
            self.add_module(f"pathway{p}_stem", ResNetBasicStem(
                dim_in[p], dim_out[p], kernel[p], stride[p], padding[p],
                norm=norm, dtype=dtype))

    def forward(self, x):
        assert len(x) == self.num_pathways, (
            f"Input tensor does not contain {self.num_pathways} pathways")
        return [getattr(self, f"pathway{p}_stem")(x[p])
                for p in range(self.num_pathways)]
