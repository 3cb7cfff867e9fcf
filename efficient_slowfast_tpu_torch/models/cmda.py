"""SlowFastDualAttention — the CMDA model, the paper's contribution (port of
``models/cmda.py:1-124``).

Reference: slowfast/models/custom_video_model_builder.py:171-445. The
SlowFast trunk, with every lateral connection the bidirectional
FuseFastAndSlow (ECA channel attention Fast→Slow, spatial attention
Slow→Fast), which also widens each stage's fast-pathway input by the slow
width over β. Its SpatialAttention runs over all T·H·W slow tokens, which
is where the flash-attention kernel serves, forward and backward. Its
stages take ``TPU.REMAT`` as SlowFast's do (the JAX package's CMDA keeps no
remat; the recompute changes memory, not values).
"""

from __future__ import annotations

import torch.nn as nn

from ..ops.norm import get_norm
from .build import MODEL_REGISTRY, get_compute_dtype
from .fuse import FuseFastAndSlow
from .slowfast import (basic_head, head_forward, res_stage, stem,
                       to_ncdhw)

# CMDA's fixed stem kernels and pool table (reference:
# custom_video_model_builder.py:151-169); the stages take their temporal
# kernels from MODEL.ARCH, as in SlowFast. The pool is 1x1x1 (the identity).
_TEMPORAL_KERNEL = [
    [[1], [5]], [[1], [3]], [[1], [3]], [[3], [3]], [[3], [3]],
]
_POOL1 = [[1, 1, 1], [1, 1, 1]]


@MODEL_REGISTRY.register()
class SlowFastDualAttention(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dtype = get_compute_dtype(cfg)
        norm = get_norm(cfg)
        w = cfg.RESNET.WIDTH_PER_GROUP
        beta = cfg.SLOWFAST.BETA_INV

        def fuse(dim_slow):
            # the fast pathway is dim_slow / β wide before each fusion
            return FuseFastAndSlow(
                dim_slow, dim_slow // beta, cfg.SLOWFAST.ALPHA, beta,
                reduction=1, norm=norm, dtype=dtype,
                use_flash=cfg.TPU.FLASH_ATTENTION,
                flash_min_tokens=cfg.TPU.FLASH_MIN_TOKENS)

        def stage(idx, dim_slow):
            # inputs after the fusion: [c_s + c_f, c_s / β + c_f]
            c_f = dim_slow // beta
            return res_stage(cfg, idx, [dim_slow + c_f, dim_slow // beta + c_f],
                             norm, dtype)

        self.s1 = stem(cfg, _TEMPORAL_KERNEL[0], norm, dtype)
        self.s1_fuse = fuse(w)
        self.s2 = stage(0, w)
        self.s2_fuse = fuse(w * 4)
        self.s3 = stage(1, w * 4)
        self.s3_fuse = fuse(w * 8)
        self.s4 = stage(2, w * 8)
        self.s4_fuse = fuse(w * 16)
        self.s5 = stage(3, w * 16)
        self.head = basic_head(cfg, _POOL1, dtype)

    def forward(self, x, bboxes=None, generator=None):
        x = self.s1([to_ncdhw(xi) for xi in x])
        x = self.s1_fuse(x)
        x = self.s2(x)
        x = self.s2_fuse(x)
        x = self.s3(x)
        x = self.s3_fuse(x)
        x = self.s4(x)
        x = self.s4_fuse(x)
        x = self.s5(x)
        return head_forward(self.head, x, bboxes, generator)
