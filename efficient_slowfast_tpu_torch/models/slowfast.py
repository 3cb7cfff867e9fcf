"""SlowFast and single-pathway ResNet video models (port of
``models/slowfast.py``).

Reference: slowfast/models/video_model_builder.py — SlowFast (:153-416),
ResNet (:419-611), _TEMPORAL_KERNEL_BASIS (:20-80), _POOL1 (:82-90),
_MODEL_STAGE_DEPTH (:16-17).

The models take the JAX package's layout: a list of channels-last pathway
tensors [slow (B, T/α, H, W, C), fast (B, T, H, W, C)], or one tensor
[(B, T, H, W, C)] for the single-pathway archs. Inside, each pathway
is the NCDHW view of that same memory (``channels_last_3d``), so no copy is
made. It returns logits in train mode and averaged post-activation scores in
eval mode (see heads.ResNetBasicHead); in train mode the head's dropout
draws from the ``generator`` passed to ``forward``. With
``DETECTION.ENABLE`` the head is the RoI head (models/detection.py):
``forward(x, bboxes)`` scores each box of ``bboxes`` (R, 5).
``TPU.REMAT`` and ``TPU.REMAT_STAGES`` rematerialise the ResStages in
training (``remat_stage``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.norm import get_norm
from ..ops.pool import max_pool3d
from .build import MODEL_REGISTRY, get_compute_dtype
from .detection import ResNetRoIHead, roi_head
from .fuse import FuseFastToSlow
from .heads import ResNetBasicHead, ResNetBasicHeadSlowPath
from .resnet import ResStage
from .stems import VideoModelStem

_MODEL_STAGE_DEPTH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
                      18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}

_TEMPORAL_KERNEL_BASIS = {
    "c2d": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "c2d_nopool": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "i3d": [[[5]], [[3]], [[3, 1]], [[3, 1]], [[1, 3]]],
    "i3d_nopool": [[[5]], [[3]], [[3, 1]], [[3, 1]], [[1, 3]]],
    "slow": [[[1]], [[1]], [[1]], [[3]], [[3]]],
    "slowfast": [[[1], [5]], [[1], [3]], [[1], [3]], [[3], [3]], [[3], [3]]],
    "fast": [[[5]], [[3]], [[3]], [[3]], [[3]]],
}

_POOL1 = {
    "c2d": [[2, 1, 1]],
    "c2d_nopool": [[1, 1, 1]],
    "i3d": [[2, 1, 1]],
    "i3d_nopool": [[1, 1, 1]],
    "slow": [[1, 1, 1]],
    "slowfast": [[1, 1, 1], [1, 1, 1]],
    "fast": [[1, 1, 1]],
}


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) → the NCDHW view of the same memory."""
    return x.permute(0, 4, 1, 2, 3)


def stem(cfg, tk0, norm, dtype) -> VideoModelStem:
    """Stage s1: one (kT, 7, 7) stem per pathway; ``tk0`` holds the two
    temporal kernel sizes."""
    w, beta = cfg.RESNET.WIDTH_PER_GROUP, cfg.SLOWFAST.BETA_INV
    return VideoModelStem(
        dim_in=cfg.DATA.INPUT_CHANNEL_NUM,
        dim_out=[w, w // beta],
        kernel=[tk0[0] + [7, 7], tk0[1] + [7, 7]],
        stride=[[1, 2, 2]] * 2,
        padding=[[tk0[0][0] // 2, 3, 3], [tk0[1][0] // 2, 3, 3]],
        norm=norm, dtype=dtype)


def remat_stage(cfg, idx) -> bool:
    """Whether stage s{idx + 2} is rematerialised in training: with
    ``TPU.REMAT``, the stages named in ``TPU.REMAT_STAGES``, or every stage
    where the list is empty (``models/slowfast.py::_stage_cls`` in JAX)."""
    sel = list(cfg.TPU.REMAT_STAGES)
    return bool(cfg.TPU.REMAT) and (not sel or idx + 2 in sel)


def res_stage(cfg, idx, dim_in, norm, dtype) -> ResStage:
    """Stage s{idx + 2} taking ``dim_in`` channels per pathway (the lateral
    fusion before it decides them): two pathways, the fast one 1/β as wide,
    or one where ``dim_in`` has one entry."""
    w = cfg.RESNET.WIDTH_PER_GROUP
    num_groups = cfg.RESNET.NUM_GROUPS
    paths = len(dim_in)
    beta = cfg.SLOWFAST.BETA_INV
    mult = 2 ** idx  # output 4·w·mult, bottleneck w·mult
    return ResStage(
        dim_in=dim_in,
        dim_out=[w * 4 * mult, w * 4 * mult // beta][:paths],
        dim_inner=[num_groups * w * mult,
                   num_groups * w * mult // beta][:paths],
        temp_kernel_sizes=_TEMPORAL_KERNEL_BASIS[cfg.MODEL.ARCH][idx + 1],
        stride=cfg.RESNET.SPATIAL_STRIDES[idx],
        num_blocks=[_MODEL_STAGE_DEPTH[cfg.RESNET.DEPTH][idx]] * paths,
        num_groups=[num_groups] * paths,
        num_block_temp_kernel=cfg.RESNET.NUM_BLOCK_TEMP_KERNEL[idx],
        nonlocal_inds=cfg.NONLOCAL.LOCATION[idx],
        nonlocal_group=cfg.NONLOCAL.GROUP[idx],
        nonlocal_pool=cfg.NONLOCAL.POOL[idx],
        instantiation=cfg.NONLOCAL.INSTANTIATION,
        trans_func_name=cfg.RESNET.TRANS_FUNC,
        stride_1x1=cfg.RESNET.STRIDE_1X1,
        dilation=cfg.RESNET.SPATIAL_DILATIONS[idx],
        zero_init_final_bn=cfg.RESNET.ZERO_INIT_FINAL_BN,
        norm=norm, dtype=dtype, remat=remat_stage(cfg, idx),
        use_flash=cfg.TPU.FLASH_ATTENTION,
        flash_min_tokens=cfg.TPU.FLASH_MIN_TOKENS)


def basic_head(cfg, pool1, dtype):
    """The head over s5's pathways (two, or one where ``pool1`` has one
    entry); its window is the training crop's (s5 is 1/32 of it) after the
    ``pool1`` pools. ``MODEL.SLOW_PATHWAY_HEAD`` classifies from the slow
    pathway alone (``basic_head_cls`` in JAX). With ``DETECTION.ENABLE``
    it is the RoI head, averaging each pathway's frames after the
    ``pool1`` pools."""
    w, beta = cfg.RESNET.WIDTH_PER_GROUP, cfg.SLOWFAST.BETA_INV
    t, a, s = cfg.DATA.NUM_FRAMES, cfg.SLOWFAST.ALPHA, cfg.DATA.CROP_SIZE
    dims, frames = ([w * 32], [t]) if len(pool1) == 1 else (
        [w * 32, w * 32 // beta], [t // a, t])
    if cfg.DETECTION.ENABLE:
        return roi_head(cfg, dims, [f // p[0] for f, p in zip(frames, pool1)],
                        dtype)
    cls = (ResNetBasicHeadSlowPath if cfg.MODEL.SLOW_PATHWAY_HEAD
           else ResNetBasicHead)
    return cls(
        dim_in=dims,
        num_classes=cfg.MODEL.NUM_CLASSES,
        pool_size=None if cfg.MULTIGRID.SHORT_CYCLE else [
            [f // p[0], s // 32 // p[1], s // 32 // p[2]]
            for f, p in zip(frames, pool1)],
        dropout_rate=cfg.MODEL.DROPOUT_RATE,
        act_func=cfg.MODEL.HEAD_ACT,
        fc_init_std=cfg.MODEL.FC_INIT_STD,
        dtype=dtype)


def head_forward(head, x, bboxes, generator):
    """The head over the trunk's pathways ``x``: the RoI head takes the
    boxes, which it needs; a classification head takes none."""
    if isinstance(head, ResNetRoIHead):
        if bboxes is None:
            raise ValueError("DETECTION.ENABLE: the forward needs the boxes "
                             "(R, 5) [batch index, x1, y1, x2, y2]")
        return head(x, bboxes, generator)
    assert bboxes is None, "boxes given to a model without DETECTION.ENABLE"
    return head(x, generator)


@MODEL_REGISTRY.register()
class SlowFast(nn.Module):
    """Two-pathway SlowFast network (stages s1–s5, fuse after s1–s4)."""

    def __init__(self, cfg):
        super().__init__()
        dtype = get_compute_dtype(cfg)
        norm = get_norm(cfg)
        self.pool_size = _POOL1[cfg.MODEL.ARCH]
        w = cfg.RESNET.WIDTH_PER_GROUP
        beta = cfg.SLOWFAST.BETA_INV
        ratio = cfg.SLOWFAST.FUSION_CONV_CHANNEL_RATIO

        def fuse(fast_dim):
            return FuseFastToSlow(fast_dim, ratio,
                                  cfg.SLOWFAST.FUSION_KERNEL_SZ,
                                  cfg.SLOWFAST.ALPHA, norm=norm, dtype=dtype)

        def stage(idx, slow_in, fast_in):
            return res_stage(cfg, idx, [slow_in + fast_in * ratio, fast_in],
                             norm, dtype)

        self.s1 = stem(cfg, _TEMPORAL_KERNEL_BASIS[cfg.MODEL.ARCH][0], norm,
                       dtype)
        self.s1_fuse = fuse(w // beta)
        self.s2 = stage(0, w, w // beta)
        self.s2_fuse = fuse(w * 4 // beta)
        self.s3 = stage(1, w * 4, w * 4 // beta)
        self.s3_fuse = fuse(w * 8 // beta)
        self.s4 = stage(2, w * 8, w * 8 // beta)
        self.s4_fuse = fuse(w * 16 // beta)
        self.s5 = stage(3, w * 16, w * 16 // beta)
        self.head = basic_head(cfg, self.pool_size, dtype)

    def forward(self, x, bboxes=None, generator=None):
        x = self.s1([to_ncdhw(xi) for xi in x])
        x = self.s1_fuse(x)
        x = self.s2(x)
        x = self.s2_fuse(x)
        if any(v != 1 for pv in self.pool_size for v in pv):
            x = [max_pool3d(xi, self.pool_size[p], self.pool_size[p])
                 for p, xi in enumerate(x)]
        x = self.s3(x)
        x = self.s3_fuse(x)
        x = self.s4(x)
        x = self.s4_fuse(x)
        x = self.s5(x)
        return head_forward(self.head, x, bboxes, generator)


@MODEL_REGISTRY.register()
class ResNet(nn.Module):
    """Single-pathway C2D / I3D / Slow / Fast ResNet (``MODEL.ARCH``), with
    ``_POOL1``'s temporal pool between s2 and s3 and the non-local blocks
    of ``NONLOCAL.LOCATION``."""

    def __init__(self, cfg):
        super().__init__()
        dtype = get_compute_dtype(cfg)
        norm = get_norm(cfg)
        self.pool_size = _POOL1[cfg.MODEL.ARCH]
        w = cfg.RESNET.WIDTH_PER_GROUP
        tk0 = _TEMPORAL_KERNEL_BASIS[cfg.MODEL.ARCH][0][0]
        self.s1 = VideoModelStem(
            dim_in=cfg.DATA.INPUT_CHANNEL_NUM[:1], dim_out=[w],
            kernel=[tk0 + [7, 7]], stride=[[1, 2, 2]],
            padding=[[tk0[0] // 2, 3, 3]], norm=norm, dtype=dtype)
        self.s2 = res_stage(cfg, 0, [w], norm, dtype)
        self.s3 = res_stage(cfg, 1, [w * 4], norm, dtype)
        self.s4 = res_stage(cfg, 2, [w * 8], norm, dtype)
        self.s5 = res_stage(cfg, 3, [w * 16], norm, dtype)
        self.head = basic_head(cfg, self.pool_size, dtype)

    def forward(self, x, bboxes=None, generator=None):
        x = self.s1([to_ncdhw(xi) for xi in x])
        x = self.s2(x)
        if any(v != 1 for v in self.pool_size[0]):
            x = [max_pool3d(x[0], self.pool_size[0], self.pool_size[0])]
        x = self.s3(x)
        x = self.s4(x)
        x = self.s5(x)
        return head_forward(self.head, x, bboxes, generator)
