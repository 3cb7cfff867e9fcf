"""ROIAlign (port of ``ops/roi_align.py``; reference: detectron2's
ROIAlign, used by slowfast/models/head_helper.py:49-81 with
``sampling_ratio=0``).

Semantics follow detectron2 ``aligned=True``: box coordinates are scaled,
then shifted by −0.5 so that samples sit on pixel centres; a sample beyond
[−1, size] on either axis contributes zero but still counts toward its
bin's average. ``sampling_ratio=0`` is the adaptive grid: each RoI samples
ceil(bin_h) × ceil(bin_w) points per bin. As in the JAX package, every
RoI takes a static grid of n = ceil(max(H, W) / out) samples per bin axis
and masks the samples beyond its own ceil(bin): shapes stay static, nothing
waits for the host, and every box clipped to the feature map is sampled
exactly (a larger box would be under-sampled at the cap). A box of zero or
negative extent, as the zero-padded box slots are, pools to exactly 0.

Bilinear interpolation is separable, and so is the validity mask, so a
bin's average of its samples is Σ_y Σ_x a_y b_x f(y, x): ``a`` (R, out, H)
holds each output row's summed y weights over its active samples divided
by their count, ``b`` (R, out, W) the same for x. Pooling is then two
matrix products: rows first, with ``a`` spread over the batch by each RoI's
batch index (so no (R, H, W, C) copy of the map is gathered), then
columns. The gradient is autograd's through them, with no scattered adds.
"""

from __future__ import annotations

import math

import torch


def _axis_weights(start, bin_size, grid, cap: int, out: int,
                  size: int) -> torch.Tensor:
    """(R, out, size): each bin's mean over its active samples of their
    bilinear weights on one axis. ``grid`` is the per-RoI sample count
    (float, <= 0 for a degenerate box: no sample is active), ``cap`` the
    static count of sample slots per bin."""
    dev = start.device
    count = torch.clamp(grid, min=1.0)
    ph = torch.arange(out, dtype=torch.float32, device=dev)
    sub = torch.arange(cap, dtype=torch.float32, device=dev) + 0.5
    pos = ph[None, :, None] + (sub[None, :] / count[:, None])[:, None, :]
    v = start[:, None, None] + pos * bin_size[:, None, None]  # (R, out, n)
    valid = (v >= -1.0) & (v <= size)
    vc = torch.clamp(v, 0.0, size - 1)
    lo = torch.floor(vc)
    hi = torch.clamp(lo + 1, max=size - 1)
    frac = vc - lo
    active = (torch.arange(cap, device=dev)[None, :] < grid[:, None])
    keep = (valid & active[:, None, :]).float() / count[:, None, None]
    at = torch.arange(size, device=dev, dtype=torch.float32)
    w = ((1.0 - frac)[..., None] * (at == lo[..., None])
         + frac[..., None] * (at == hi[..., None]))  # (R, out, n, size)
    return (w * keep[..., None]).sum(dim=2)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size: int,
              spatial_scale: float, sampling_ratio: int = 0,
              aligned: bool = True) -> torch.Tensor:
    """features (B, H, W, C) channels-last, boxes (R, 5) [batch_idx, x1,
    y1, x2, y2] in input coordinates → (R, output_size, output_size, C) in
    float32."""
    b, h, w, c = features.shape
    out = output_size
    r = boxes.shape[0]
    boxes = boxes.float()
    batch_idx = boxes[:, 0].long()
    offset = 0.5 if aligned else 0.0
    x1 = boxes[:, 1] * spatial_scale - offset
    y1 = boxes[:, 2] * spatial_scale - offset
    x2 = boxes[:, 3] * spatial_scale - offset
    y2 = boxes[:, 4] * spatial_scale - offset
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    bin_w = roi_w / out
    bin_h = roi_h / out
    if sampling_ratio > 0:
        cap = int(sampling_ratio)
        g_h = torch.full((r,), float(cap), device=boxes.device)
        g_w = g_h
    else:
        # the raw ceil(bin), not clamped below: <= 0 for a degenerate box,
        # which then has no active sample and pools to 0
        cap = max(1, math.ceil(max(h, w) / out))
        g_h = torch.clamp(torch.ceil(bin_h), max=float(cap))
        g_w = torch.clamp(torch.ceil(bin_w), max=float(cap))
    a = _axis_weights(y1, bin_h, g_h, cap, out, h)  # (R, out, H)
    bx = _axis_weights(x1, bin_w, g_w, cap, out, w)  # (R, out, W)
    # rows: a spread over the batch (zero outside each RoI's own clip)
    onehot = (batch_idx[:, None] == torch.arange(b, device=boxes.device))
    a_b = (a[:, :, None, :] * onehot[:, None, :, None]).reshape(r * out, b * h)
    rows = a_b @ features.float().reshape(b * h, w * c)  # (R·out, W·C)
    # columns: (R, 1, out, W) @ (R, out, W, C) → (R, out_y, out_x, C)
    return torch.matmul(bx[:, None], rows.reshape(r, out, w, c))
