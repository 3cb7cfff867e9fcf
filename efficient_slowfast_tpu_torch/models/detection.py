"""Detection head for AVA (port of ``models/detection.py``; reference:
slowfast/models/head_helper.py:11-130).

Per pathway: average over T, ROIAlign (aligned semantics), max over the
bin grid; then the pathways' channels concatenated, dropout, the linear
projection and the activation. Unlike the classification head, the
activation is applied in train mode too (reference :126-129: AVA trains
BCE on sigmoid scores). Pooling runs in float32, the projection in the
compute dtype, and the scores come out in float32, one row per RoI.
Under ``TPU.SPATIAL_SHARD`` ROIAlign reads the whole height of each
pathway (``spatial.gather_height``): boxes cross the bands.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.conv import Linear
from ..ops.roi_align import roi_align
from ..parallel import spatial
from .heads import dropout


class ResNetRoIHead(nn.Module):
    def __init__(self, dim_in: Sequence[int], num_classes: int,
                 pool_size: Sequence[Sequence[int]],
                 resolution: Sequence[Sequence[int]],
                 scale_factor: Sequence[int], dropout_rate: float = 0.0,
                 act_func: str = "sigmoid", aligned: bool = True,
                 fc_init_std: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if act_func not in ("softmax", "sigmoid"):
            raise NotImplementedError(act_func)
        self.pool_size = pool_size
        self.resolution = resolution
        self.scale_factor = scale_factor
        self.dropout_rate = dropout_rate
        self.act_func = act_func
        self.aligned = aligned
        self.projection = Linear(sum(dim_in), num_classes,
                                 init_std=fc_init_std, dtype=dtype)

    def forward(self, inputs, bboxes: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """``inputs``: the pathways as NCDHW views of channels-last memory;
        ``bboxes`` (R, 5) [batch index, x1, y1, x2, y2] in input pixels."""
        assert len(inputs) == len(self.pool_size), (
            f"Input tensor does not contain {len(self.pool_size)} pathways")
        pooled = []
        for p, x in enumerate(inputs):
            x = spatial.gather_height(x)  # boxes cross the bands
            assert x.shape[2] == self.pool_size[p][0], (
                f"pathway {p}: T={x.shape[2]} != pool {self.pool_size[p][0]}")
            # (B, T, H, W, C), the memory's own order: mean over T in f32
            feat = torch.mean(x.permute(0, 2, 3, 4, 1), dim=1,
                              dtype=torch.float32)
            rois = roi_align(feat, bboxes, self.resolution[p][0],
                             1.0 / self.scale_factor[p], 0, self.aligned)
            pooled.append(rois.amax(dim=(1, 2)))  # (R, C)
        x = torch.cat(pooled, dim=-1)
        if self.training and self.dropout_rate > 0:
            x = dropout(x, self.dropout_rate, generator)
        x = self.projection(x).float()
        x = (torch.softmax(x, dim=-1) if self.act_func == "softmax"
             else torch.sigmoid(x))
        return x.reshape(x.shape[0], -1)


def roi_head(cfg, dim_in, frames, dtype) -> ResNetRoIHead:
    """The RoI head over s5's pathways, of ``dim_in`` channels and
    ``frames`` frames each."""
    res = cfg.DETECTION.ROI_XFORM_RESOLUTION
    return ResNetRoIHead(
        dim_in=dim_in,
        num_classes=cfg.MODEL.NUM_CLASSES,
        pool_size=[[f, 1, 1] for f in frames],
        resolution=[[res] * 2] * len(frames),
        scale_factor=[cfg.DETECTION.SPATIAL_SCALE_FACTOR] * len(frames),
        dropout_rate=cfg.MODEL.DROPOUT_RATE,
        act_func=cfg.MODEL.HEAD_ACT,
        aligned=cfg.DETECTION.ALIGNED,
        fc_init_std=cfg.MODEL.FC_INIT_STD,
        dtype=dtype)
