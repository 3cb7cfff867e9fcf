"""SlowFastGhostNet, the two-pathway inflated GhostNet with CMDA fusion
(port of ``models/ghostnet.py``).

Reference: slowfast/models/custom_video_model_builder.py:792-1026 (model),
ghostnet_helper.py (GhostModule :71-99, GhostBottleneck :102-163,
SqueezeExcite :34-53), stem_helper.py:309-336, head_helper.py:630-700.

Stage cfgs [k, t, c, SE, s] (reference: custom_video_model_builder.py:814-844);
slow channels make_divisible(c·w, 4), fast make_divisible(c·w // β, 4).
As in the reference, GhostNetBasicHead overwrites its softmax/sigmoid
``act`` with ReLU (head_helper.py:665), so its eval scores are the mean of
ReLU(logits), not probabilities. The stages ignore ``TPU.REMAT``, as the
JAX package's do.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Conv3d
from ..ops.norm import BatchNorm3d, get_norm
from ..ops.pool import adaptive_avg_pool3d_1
from .build import MODEL_REGISTRY, get_compute_dtype
from .common_efficient import (ConvBNAct, EfficientStem, PathwayStage,
                               classifier, cmda_fuse, hard_sigmoid,
                               make_divisible)
from .fuse import _cat
from .heads import dropout
from .slowfast import to_ncdhw

# [kernel, hidden (t), out (c), se_ratio, stride] per block, grouped into the
# 5 fusion-delimited stages of the SlowFast variant
_GHOST_STAGE_CFGS = [
    [[3, 16, 16, 0, 1]],
    [[3, 48, 24, 0, 2], [3, 72, 24, 0, 1]],
    [[5, 72, 40, 0.25, 2], [5, 120, 40, 0.25, 1]],
    [[3, 240, 80, 0, 2], [3, 200, 80, 0, 1], [3, 184, 80, 0, 1],
     [3, 184, 80, 0, 1], [3, 480, 112, 0.25, 1], [3, 672, 112, 0.25, 1]],
    [[5, 672, 160, 0.25, 2], [5, 960, 160, 0, 1], [5, 960, 160, 0.25, 1],
     [5, 960, 160, 0, 1], [5, 960, 160, 0.25, 1]],
]


def stage_cfgs(width_mult: float, beta_inv: int):
    """[slow, fast] rows of every stage, hidden and out channels scaled and
    rounded to multiples of 4."""
    def rows(scale):
        return [[[k, scale(t), scale(c), se, s] for k, t, c, se, s in stage]
                for stage in _GHOST_STAGE_CFGS]

    return (rows(lambda v: make_divisible(v * width_mult, 4)),
            rows(lambda v: make_divisible(v * width_mult // beta_inv, 4)))


class SqueezeExcite(nn.Module):
    """Global mean → 1×1×1 conv (reduce) → ReLU → 1×1×1 conv (expand) →
    hard sigmoid gate."""

    def __init__(self, in_chs: int, se_ratio: float = 0.25, divisor: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        reduced = make_divisible(in_chs * se_ratio, divisor)
        self.conv_reduce = Conv3d(in_chs, reduced, 1, bias=True, dtype=dtype)
        self.conv_expand = Conv3d(reduced, in_chs, 1, bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.conv_reduce(adaptive_avg_pool3d_1(x)))
        return x * hard_sigmoid(self.conv_expand(y))


class GhostModule(nn.Module):
    """Primary (1, k, k) conv and its cheap 3×3×3 depthwise expansion,
    concatenated, cut to ``oup`` channels."""

    def __init__(self, inp: int, oup: int, kernel_size: int = 1,
                 ratio: int = 2, dw_size: int = 3, stride: int = 1,
                 relu: bool = True,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.oup = oup
        init_c = math.ceil(oup / ratio)
        new_c = init_c * (ratio - 1)
        act = nn.ReLU if relu else None
        k = kernel_size
        self.primary_conv = ConvBNAct(inp, init_c, (1, k, k),
                                      (1, stride, stride), (0, k // 2, k // 2),
                                      act=act, norm=norm, dtype=dtype)
        self.cheap_operation = ConvBNAct(init_c, new_c, dw_size, 1,
                                         dw_size // 2, groups=init_c, act=act,
                                         norm=norm, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.primary_conv(x)
        return _cat([x1, self.cheap_operation(x1)])[:, :self.oup]


class GhostBottleneck(nn.Module):
    """ghost1 → (stride > 1: a (1, k, k) depthwise conv and BN) → (SE) →
    ghost2, plus the identity or a depthwise + pointwise shortcut."""

    def __init__(self, in_chs: int, mid_chs: int, out_chs: int,
                 dw_kernel_size: int = 3, stride: int = 1,
                 se_ratio: float = 0.0,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k, s = dw_kernel_size, stride
        pad = (0, (k - 1) // 2, (k - 1) // 2)
        self.stride = s
        self.ghost1 = GhostModule(in_chs, mid_chs, relu=True, norm=norm,
                                  dtype=dtype)
        if s > 1:
            self.conv_dw = Conv3d(mid_chs, mid_chs, (1, k, k), (1, s, s), pad,
                                  groups=mid_chs, dtype=dtype)
            self.bn_dw = norm(mid_chs)
        self.se = (SqueezeExcite(mid_chs, se_ratio, dtype=dtype)
                   if se_ratio > 0 else None)
        self.ghost2 = GhostModule(mid_chs, out_chs, relu=False, norm=norm,
                                  dtype=dtype)
        self.shortcut = None if in_chs == out_chs and s == 1 else \
            nn.Sequential(
                *ConvBNAct(in_chs, in_chs, (1, k, k), (1, s, s), pad,
                           groups=in_chs, act=None, norm=norm, dtype=dtype),
                *ConvBNAct(in_chs, out_chs, 1, act=None, norm=norm,
                           dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ghost1(x)
        if self.stride > 1:
            y = self.bn_dw(self.conv_dw(y))
        if self.se is not None:
            y = self.se(y)
        y = self.ghost2(y)
        return y + (x if self.shortcut is None else self.shortcut(x))


class GhostNetStage(PathwayStage):
    """Both pathways' rows of one stage; pathway p takes ``dim_in[p]``
    channels. Named by the out channels of its last row."""

    def __init__(self, dim_in, slow_cfg, fast_cfg,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        chains = []
        for cin, rows in zip(dim_in, (slow_cfg, fast_cfg)):
            blocks = []
            for k, exp, c, se, s in rows:
                out = make_divisible(c, 2)
                blocks.append(GhostBottleneck(
                    cin, make_divisible(exp, 2), out, int(k), int(s),
                    float(se), norm=norm, dtype=dtype))
                cin = out
            chains.append(blocks)
        super().__init__([slow_cfg[-1][2], fast_cfg[-1][2]], chains)
        self.dim_out = [make_divisible(r[-1][2], 2)
                        for r in (slow_cfg, fast_cfg)]


class _HeadConv(nn.Module):
    """1×1×1 conv → BN (``bn1``) → ReLU."""

    def __init__(self, dim_in: int, dim_out: int, norm, dtype):
        super().__init__()
        self.conv = Conv3d(dim_in, dim_out, 1, dtype=dtype)
        self.bn1 = norm(dim_out)

    def forward(self, x):
        return F.relu(self.bn1(self.conv(x)))


class GhostNetBasicHead(nn.Module):
    """Per pathway: the stage-5 1×1×1 conv → BN → ReLU, global average
    pool, ``conv_head`` (1×1×1 with bias) → ReLU; then concat, dropout,
    linear. Eval: ReLU, then the mean (the reference's ``act`` reassigned
    to ReLU, head_helper.py:665)."""

    def __init__(self, dim_in: Sequence[int], num_classes: int,
                 mid_channel: Sequence[int], output_channel: Sequence[int],
                 dropout_rate: float = 0.0, fc_init_std: float = 0.01,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.sides = ("slow", "fast")
        for p, side in enumerate(self.sides):
            self.add_module(f"stage5_conv_{side}", _HeadConv(
                dim_in[p], mid_channel[p], norm, dtype))
            self.add_module(f"conv_head_{side}", Conv3d(
                mid_channel[p], output_channel[p], 1, bias=True, dtype=dtype))
        self.classifier = classifier(sum(output_channel), num_classes,
                                     fc_init_std, dtype)

    def forward(self, inputs, generator: Optional[torch.Generator] = None):
        pools = []
        for x, side in zip(inputs, self.sides):
            x = adaptive_avg_pool3d_1(getattr(self, f"stage5_conv_{side}")(x))
            pools.append(F.relu(getattr(self, f"conv_head_{side}")(x)))
        x = torch.cat(pools, dim=1).permute(0, 2, 3, 4, 1)  # (B,1,1,1,C)
        if self.training and self.dropout_rate > 0:
            x = dropout(x, self.dropout_rate, generator)
        x = self.classifier[1](x)
        if not self.training:
            x = F.relu(x.float()).mean(dim=(1, 2, 3))
        return x.reshape(x.shape[0], -1)


@MODEL_REGISTRY.register()
class SlowFastGhostNet(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dtype = get_compute_dtype(cfg)
        norm = get_norm(cfg)
        beta = cfg.SLOWFAST.BETA_INV
        wm = float(cfg.SLOWFAST.WIDTH_MULTI)
        slow_cfgs, fast_cfgs = stage_cfgs(wm, beta)

        dims = [make_divisible(16 * wm, 4), make_divisible(16 * wm // beta, 4)]
        self.s0 = EfficientStem(cfg.DATA.INPUT_CHANNEL_NUM, dims, norm=norm,
                                dtype=dtype)
        # s1..s5, a fusion after each of s1..s4 (reference forward :1008-1022)
        for i in range(5):
            stage = GhostNetStage(dims, slow_cfgs[i], fast_cfgs[i], norm=norm,
                                  dtype=dtype)
            self.add_module(f"s{i + 1}", stage)
            dims = stage.dim_out
            if i < 4:
                fuse, dims = cmda_fuse(cfg, dims, norm, dtype)
                self.add_module(f"s{i + 1}_fuse", fuse)
        self.head = GhostNetBasicHead(
            dims, cfg.MODEL.NUM_CLASSES,
            mid_channel=[slow_cfgs[4][-1][1], fast_cfgs[4][-1][1]],
            output_channel=[int(1280 * wm), int(1280 * wm // beta)],
            dropout_rate=cfg.MODEL.DROPOUT_RATE,
            fc_init_std=cfg.MODEL.FC_INIT_STD, norm=norm, dtype=dtype)

    def forward(self, x, generator=None):
        x = self.s0([to_ncdhw(xi) for xi in x])
        for i in range(1, 6):
            x = getattr(self, f"s{i}")(x)
            if i < 5:
                x = getattr(self, f"s{i}_fuse")(x)
        return self.head(x, generator)
