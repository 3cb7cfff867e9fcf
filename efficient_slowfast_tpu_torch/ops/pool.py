"""Pooling of NCDHW tensors (port of ``ops/pool.py:21-67``).

Torch-style symmetric integer padding; max pooling pads with -inf and
average pooling counts the padding (``count_include_pad=True``), as the
JAX package does. The global means of the efficient heads and the CMDA
fusion's temporal squeeze and expand are here too.

A height-split activation (``TPU.SPATIAL_SHARD``) is pooled on its band
with its neighbours' halo rows (-inf or zero beyond the frame), or whole
where the output would not split (``parallel/spatial.py::window``); its
global means sum the bands over the space group.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import spatial


def _triple(v) -> tuple:
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def max_pool3d(x: torch.Tensor, kernel, stride=None,
               padding=(0, 0, 0)) -> torch.Tensor:
    k = _triple(kernel)
    s = _triple(stride) if stride is not None else k
    p = _triple(padding)
    xin, ph, split = spatial.window(x, k[1], s[1], p[1], fill=float("-inf"))
    y = F.max_pool3d(xin, k, s, (p[0], ph, p[2]))
    return spatial.as_split(y) if split else y


def avg_pool3d(x: torch.Tensor, kernel, stride=None,
               padding=(0, 0, 0)) -> torch.Tensor:
    k = _triple(kernel)
    s = _triple(stride) if stride is not None else k
    p = _triple(padding)
    # a window larger than the padded input is a stale cfg (e.g. the head
    # pool of another NUM_FRAMES): fail here, not as NaNs downstream
    size = list(x.shape[2:])
    size[1] = spatial.global_count(x, size[1])
    for d in range(3):
        if k[d] > size[d] + 2 * p[d]:
            raise ValueError(
                f"avg_pool3d window {k} larger than input "
                f"{tuple(size)} (padding {p})")
    # the halo's zero rows are the padding that count_include_pad counts
    xin, ph, split = spatial.window(x, k[1], s[1], p[1])
    y = F.avg_pool3d(xin, k, s, (p[0], ph, p[2]), count_include_pad=True)
    return spatial.as_split(y) if split else y


def adaptive_avg_pool3d_1(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool3d((1, 1, 1)): the mean over (T, H, W), kept as
    (B, C, 1, 1, 1)."""
    return spatial.mean(x, (2, 3, 4), keepdim=True)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """The mean over (T, H, W) → (B, C)."""
    return spatial.mean(x, (2, 3, 4))


def temporal_downsample_max(x: torch.Tensor, alpha: int) -> torch.Tensor:
    """MaxPool3d((alpha, 1, 1)) — CMDA Fast→Slow temporal squeeze
    (reference: custom_video_model_builder.py:127-135)."""
    return max_pool3d(x, (alpha, 1, 1), (alpha, 1, 1))


def temporal_upsample_nearest(x: torch.Tensor, alpha: int) -> torch.Tensor:
    """Nearest temporal upsample ×alpha (each frame repeated alpha times) —
    CMDA Slow→Fast expand (reference: custom_video_model_builder.py:137-146).

    Repeats in the (B, T, H, W, C) view, so a ``channels_last_3d`` input
    gives a ``channels_last_3d`` output without another copy.
    """
    cl = x.permute(0, 2, 3, 4, 1)
    return cl.repeat_interleave(alpha, dim=1).permute(0, 4, 1, 2, 3)
