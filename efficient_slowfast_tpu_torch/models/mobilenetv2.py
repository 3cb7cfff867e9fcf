"""SlowFastMoibleNetV2, the two-pathway inflated MobileNetV2 with CMDA
fusion (port of ``models/mobilenetv2.py``).

Reference: slowfast/models/custom_video_model_builder.py:1057-1285 (model;
the class keeps the reference's "Moible" spelling, so that the yamls
resolve), mobilenetv2_helper.py (InvertedResidual :30-68, stage :258-345),
stem_helper.py:181-232, head_helper.py:436-486.

Stage layout (reference forward :1262-1285): s1 stem → s2 = settings[0:2] →
s3_fuse → s4 = settings[2:3] → s4_fuse → s5 = settings[3:4] → s5_fuse →
s6 = settings[4:5] → s7 = settings[5:6] → s7_fuse → s8 = settings[6:] → head.
The stages ignore ``TPU.REMAT``, as the JAX package's do.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.norm import BatchNorm3d, get_norm
from .build import MODEL_REGISTRY, get_compute_dtype
from .common_efficient import (ConvBNAct, EfficientBasicHead, EfficientStem,
                               PathwayStage, cmda_fuse)
from .slowfast import to_ncdhw

# (expand ratio t, channels c, repeats n, stride s) per setting row
# (reference: custom_video_model_builder.py:1029-1054)
_SETTINGS = [
    (1, 16, 1, (1, 1, 1)),
    (6, 24, 2, (1, 2, 2)),
    (6, 32, 3, (1, 2, 2)),
    (6, 64, 4, (1, 2, 2)),
    (6, 96, 3, (1, 1, 1)),
    (6, 160, 3, (1, 2, 2)),
    (6, 320, 1, (1, 1, 1)),
]
# stage → its rows, between the fusions s3, s4, s5 and s7
_LAYOUT = {"s2": _SETTINGS[0:2], "s4": _SETTINGS[2:3], "s5": _SETTINGS[3:4],
           "s6": _SETTINGS[4:5], "s7": _SETTINGS[5:6], "s8": _SETTINGS[6:]}
_FUSE_AFTER = {"s2": "s3_fuse", "s4": "s4_fuse", "s5": "s5_fuse",
               "s7": "s7_fuse"}


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted residual (``conv``: the 1×1 expansion where
    t != 1, the 3×3×3 depthwise conv, ReLU6 after both, the linear 1×1
    projection), with the identity added where the stride is 1 and the
    widths agree."""

    def __init__(self, inp: int, oup: int, stride: Tuple[int, int, int],
                 expand_ratio: int,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = round(inp * expand_ratio)
        self.use_res = tuple(stride) == (1, 1, 1) and inp == oup
        layers = []
        if expand_ratio != 1:
            layers += ConvBNAct(inp, hidden, 1, act=nn.ReLU6, norm=norm,
                                dtype=dtype)
        layers += ConvBNAct(hidden, hidden, 3, stride, 1, groups=hidden,
                            act=nn.ReLU6, norm=norm, dtype=dtype)
        layers += ConvBNAct(hidden, oup, 1, act=None, norm=norm, dtype=dtype)
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_res else y


def stage_widths(rows, width_mult: float, beta_inv: int) -> list:
    """Each row's output channels [slow, fast]: int(c·w) and int(c·w //
    β), the float floor division as the reference computes it."""
    return [[int(c * width_mult), int(c * width_mult // beta_inv)]
            for _, c, _, _ in rows]


class MobileNetV2Stage(PathwayStage):
    """A run of setting rows in both pathways, the fast one's channels
    ``int(c·w // β)`` (reference: mobilenetv2_helper.py:258-345); pathway
    p takes ``dim_in[p]`` channels. Named by the raw channels of its first
    row."""

    def __init__(self, settings: Sequence, dim_in, width_mult: float,
                 beta_inv: int, norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        widths = stage_widths(settings, width_mult, beta_inv)
        chains = []
        for p, cin in enumerate(dim_in):
            blocks = []
            for (t, _, n, s), out in zip(settings, widths):
                for i in range(n):
                    blocks.append(InvertedResidual(
                        cin, out[p], tuple(s) if i == 0 else (1, 1, 1), t,
                        norm=norm, dtype=dtype))
                    cin = out[p]
            chains.append(blocks)
        super().__init__([settings[0][1]] * len(dim_in), chains)
        self.dim_out = widths[-1]


@MODEL_REGISTRY.register()
class SlowFastMoibleNetV2(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dtype = get_compute_dtype(cfg)
        norm = get_norm(cfg)
        beta = cfg.SLOWFAST.BETA_INV
        wm = float(cfg.SLOWFAST.WIDTH_MULTI)
        last_channel = int(1280 * wm) if wm > 1.0 else 1280

        dims = [int(32 * wm), int(32 * (wm / beta))]
        self.s1 = EfficientStem(cfg.DATA.INPUT_CHANNEL_NUM, dims,
                                act=nn.ReLU6, features=True, norm=norm,
                                dtype=dtype)
        for name, rows in _LAYOUT.items():
            stage = MobileNetV2Stage(rows, dims, wm, beta, norm=norm,
                                     dtype=dtype)
            self.add_module(name, stage)
            dims = stage.dim_out
            if name in _FUSE_AFTER:
                fuse, dims = cmda_fuse(cfg, dims, norm, dtype)
                self.add_module(_FUSE_AFTER[name], fuse)
        self.head = EfficientBasicHead(
            dims, cfg.MODEL.NUM_CLASSES,
            last_channel=[last_channel, last_channel // beta], act=nn.ReLU6,
            dropout_rate=cfg.MODEL.DROPOUT_RATE, act_func=cfg.MODEL.HEAD_ACT,
            fc_init_std=cfg.MODEL.FC_INIT_STD, norm=norm, dtype=dtype)

    def forward(self, x, generator=None):
        x = self.s1([to_ncdhw(xi) for xi in x])
        for name in _LAYOUT:
            x = getattr(self, name)(x)
            if name in _FUSE_AFTER:
                x = getattr(self, _FUSE_AFTER[name])(x)
        return self.head(x, generator)
