"""SlowFastShuffleNetV2, the two-pathway inflated ShuffleNetV2 with CMDA
fusion (port of ``models/shufflenetv2.py``).

Reference: slowfast/models/custom_video_model_builder.py:448-617 (model),
shufflenetv2_helper.py (InvertedResidual :46-112, stage :222-297),
stem_helper.py:236-270, head_helper.py:499-557.

Per-pathway channel tables (reference: custom_video_model_builder.py:470-486;
w1.0 and w2.0 differ from the plain ShuffleNetV2 to keep channels divisible
after the CMDA fusion); fast channels = slow // BETA_INV. Each CMDA fusion
widens the pathways that the next stage takes (``cmda_fuse``). The stages
ignore ``TPU.REMAT``, as the JAX package's do.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from ..ops.norm import BatchNorm3d, get_norm
from .build import MODEL_REGISTRY, get_compute_dtype
from .common_efficient import (ConvBNAct, EfficientBasicHead, EfficientStem,
                               PathwayStage, cmda_fuse, shuffle_cat)
from .slowfast import to_ncdhw

_STAGE_OUT_CHANNELS = {
    0.25: [-1, 24, 32, 64, 128, 1024],
    0.5: [-1, 24, 48, 96, 192, 1024],
    1.0: [-1, 24, 116, 240, 464, 1024],
    1.5: [-1, 24, 176, 352, 704, 1024],
    2.0: [-1, 24, 224, 496, 976, 2048],
}
_STAGE_REPEATS = [4, 8, 4]


class InvertedResidual(nn.Module):
    """ShuffleNetV2 unit: at stride 1 the second half of the channels runs
    ``banch2`` beside the first half; at stride 2 ``banch1`` and ``banch2``
    both take all of them; then the two halves are shuffled (groups 2).
    The depthwise conv is 3×3×3 with stride (1, s, s)."""

    def __init__(self, inp: int, oup: int, stride: int,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        half = oup // 2
        self.stride = s = stride
        if s != 1:
            self.banch1 = nn.Sequential(
                *ConvBNAct(inp, inp, 3, (1, s, s), 1, groups=inp, act=None,
                           norm=norm, dtype=dtype),
                *ConvBNAct(inp, half, 1, norm=norm, dtype=dtype))
        branch_in = inp - inp // 2 if s == 1 else inp
        self.banch2 = nn.Sequential(
            *ConvBNAct(branch_in, half, 1, norm=norm, dtype=dtype),
            *ConvBNAct(half, half, 3, (1, s, s), 1, groups=half, act=None,
                       norm=norm, dtype=dtype),
            *ConvBNAct(half, half, 1, norm=norm, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            c = x.shape[1]
            return shuffle_cat(x[:, :c // 2], self.banch2(x[:, c // 2:]))
        return shuffle_cat(self.banch1(x), self.banch2(x))


class ShuffleNetV2Stage(PathwayStage):
    """One stage of both pathways: ``_STAGE_REPEATS[idxstage]`` units a
    pathway, the first of stride 2; pathway p takes ``dim_in[p]`` channels
    and is named by ``dim_out[p]``. A unit gives 2·(oup // 2) channels, one
    fewer than an odd ``oup`` (a fast pathway at β 4: 116 // 4 = 29 gives
    28), and ``self.dim_out`` is what the stage gives."""

    def __init__(self, idxstage: int, dim_in, dim_out,
                 norm: Callable[..., nn.Module] = BatchNorm3d,
                 dtype: torch.dtype = torch.float32):
        reps = _STAGE_REPEATS[idxstage]
        self_out = [2 * (c // 2) for c in dim_out]
        super().__init__(dim_out, [
            [InvertedResidual(cin if i == 0 else out, cout,
                              2 if i == 0 else 1, norm=norm, dtype=dtype)
             for i in range(reps)]
            for cin, cout, out in zip(dim_in, dim_out, self_out)])
        self.dim_out = self_out


@MODEL_REGISTRY.register()
class SlowFastShuffleNetV2(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dtype = get_compute_dtype(cfg)
        norm = get_norm(cfg)
        beta = cfg.SLOWFAST.BETA_INV
        wm = float(cfg.SLOWFAST.WIDTH_MULTI)
        if wm not in _STAGE_OUT_CHANNELS:
            raise ValueError(f"width multiplier {wm} not supported")
        slow = _STAGE_OUT_CHANNELS[wm]
        fast = [c // beta for c in slow]

        self.s1 = EfficientStem(cfg.DATA.INPUT_CHANNEL_NUM,
                                [slow[1], fast[1]], with_pool=True,
                                norm=norm, dtype=dtype)
        self.s1_fuse, dims = cmda_fuse(cfg, [slow[1], fast[1]], norm, dtype)
        for i, name in enumerate(("s2", "s3", "s4")):
            stage = ShuffleNetV2Stage(i, dims, [slow[i + 2], fast[i + 2]],
                                      norm=norm, dtype=dtype)
            self.add_module(name, stage)
            fuse, dims = cmda_fuse(cfg, stage.dim_out, norm, dtype)
            self.add_module(f"{name}_fuse", fuse)
        self.head = EfficientBasicHead(
            dims, cfg.MODEL.NUM_CLASSES, last_channel=[slow[-1], fast[-1]],
            nested=True, dropout_rate=cfg.MODEL.DROPOUT_RATE,
            act_func=cfg.MODEL.HEAD_ACT, fc_init_std=cfg.MODEL.FC_INIT_STD,
            norm=norm, dtype=dtype)

    def forward(self, x, generator=None):
        x = self.s1_fuse(self.s1([to_ncdhw(xi) for xi in x]))
        for name in ("s2", "s3", "s4"):
            x = getattr(self, f"{name}_fuse")(getattr(self, name)(x))
        return self.head(x, generator)
