"""SlowFastShuffleNet, the two-pathway inflated ShuffleNet (v1) with CMDA
fusion (port of ``models/shufflenet.py``).

Reference: slowfast/models/custom_video_model_builder.py:620-789 (model),
shufflenet_helper.py (Bottleneck :37-85, stage :221-297),
stem_helper.py:273-306, head_helper.py:562-609.

Group-count → out_planes table at custom_video_model_builder.py:646-661;
the width multiplier scales every plane count; fast channels = slow //
BETA_INV. The stages ignore ``TPU.REMAT``, as the JAX package's do.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Conv3d
from ..ops.norm import BatchNorm3d, get_norm
from ..ops.pool import avg_pool3d
from .build import MODEL_REGISTRY, get_compute_dtype
from .common_efficient import (EfficientBasicHead, EfficientStem,
                               PathwayStage, channel_shuffle, cmda_fuse)
from .fuse import _cat
from .slowfast import to_ncdhw

_OUT_PLANES = {
    1: [24, 144, 288, 567],
    2: [24, 200, 400, 800],
    3: [24, 240, 480, 960],
    4: [24, 272, 544, 1088],
    8: [24, 384, 768, 1536],
}
_NUM_BLOCKS = [4, 8, 4]


class ShortcutPool(nn.Module):
    """AvgPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)), the padding counted,
    summed in float32 (the CPU has no bfloat16 avg_pool3d)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool3d(x.float(), (1, 3, 3), (1, 2, 2),
                          (0, 1, 1)).to(x.dtype)


class Bottleneck(nn.Module):
    """ShuffleNet (v1) grouped bottleneck (reference:
    shufflenet_helper.py:37-85): grouped 1×1 conv, shuffle, 3×3×3
    depthwise conv, grouped 1×1 conv. Stride 2: mid = out // 2, the branch
    gives out - out // 2 channels, concatenated with a 1×1-conv shortcut
    average-pooled (1, 3, 3)/s(1, 2, 2), the padding counted; stride 1: a
    residual add. The first grouped conv takes groups 1 where the input has
    the stem's 24 channels."""

    def __init__(self, in_planes: int, out_planes: int, stride: int,
                 groups: int, norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.groups = stride, groups
        if stride == 2:
            mid, out_c = out_planes // 2, out_planes - out_planes // 2
        else:
            mid, out_c = out_planes // 4, out_planes
        g = 1 if in_planes == 24 else groups
        self.conv1 = Conv3d(in_planes, mid, 1, groups=g, dtype=dtype)
        self.bn1 = norm(mid)
        self.conv2 = Conv3d(mid, mid, 3, (1, stride, stride), 1, groups=mid,
                            dtype=dtype)
        self.bn2 = norm(mid)
        self.conv3 = Conv3d(mid, out_c, 1, groups=groups, dtype=dtype)
        self.bn3 = norm(out_c)
        if stride == 2:
            self.shortcut = nn.Sequential(
                Conv3d(in_planes, mid, 1, dtype=dtype), ShortcutPool())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = channel_shuffle(y, self.groups)
        y = self.bn2(self.conv2(y))
        y = self.bn3(self.conv3(y))
        if self.stride == 2:
            return F.relu(_cat([y, self.shortcut(x)]))
        return F.relu(y + x)


class ShuffleNetStage(PathwayStage):
    """``num_block`` bottlenecks a pathway, the first of stride 2; pathway
    p takes ``dim_in[p]`` channels and gives ``dim_out[p]``."""

    def __init__(self, dim_in, dim_out, num_block: int, groups: int,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim_out, [
            [Bottleneck(cin if i == 0 else cout, cout, 2 if i == 0 else 1,
                        groups, norm=norm, dtype=dtype)
             for i in range(num_block)]
            for cin, cout in zip(dim_in, dim_out)])


@MODEL_REGISTRY.register()
class SlowFastShuffleNet(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dtype = get_compute_dtype(cfg)
        norm = get_norm(cfg)
        beta = cfg.SLOWFAST.BETA_INV
        groups = cfg.SLOWFAST.GROUPS
        wm = float(cfg.SLOWFAST.WIDTH_MULTI)
        if groups not in _OUT_PLANES:
            raise ValueError(f"{groups} groups is not supported")
        slow = [int(c * wm) for c in _OUT_PLANES[groups]]
        fast = [c // beta for c in slow]

        self.s1 = EfficientStem(cfg.DATA.INPUT_CHANNEL_NUM,
                                [slow[0], fast[0]], with_pool=True,
                                norm=norm, dtype=dtype)
        self.s1_fuse, dims = cmda_fuse(cfg, [slow[0], fast[0]], norm, dtype)
        for i, name in enumerate(("s2", "s3", "s4")):
            out = [slow[i + 1], fast[i + 1]]
            self.add_module(name, ShuffleNetStage(
                dims, out, _NUM_BLOCKS[i], groups, norm=norm, dtype=dtype))
            fuse, dims = cmda_fuse(cfg, out, norm, dtype)
            self.add_module(f"{name}_fuse", fuse)
        # ShuffleNetBasicHead: the pool straight after the trunk, no conv
        self.head = EfficientBasicHead(
            dims, cfg.MODEL.NUM_CLASSES, dropout_rate=cfg.MODEL.DROPOUT_RATE,
            act_func=cfg.MODEL.HEAD_ACT, fc_init_std=cfg.MODEL.FC_INIT_STD,
            norm=norm, dtype=dtype)

    def forward(self, x, generator=None):
        x = self.s1_fuse(self.s1([to_ncdhw(xi) for xi in x]))
        for name in ("s2", "s3", "s4"):
            x = getattr(self, f"{name}_fuse")(getattr(self, name)(x))
        return self.head(x, generator)
