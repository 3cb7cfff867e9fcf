"""Pathway packing (port of ``data/pathways.py``; reference:
slowfast/datasets/utils.py:73-148).

Fast pathway = all T frames; slow pathway = T//α frames picked by the
reference's linspace(0, T-1, T//α) index rule. Batched, on the frames'
device; channels-last (B, T, H, W, C) in and out.
"""

from __future__ import annotations

import numpy as np
import torch


def slow_pathway_indices(num_frames: int, alpha: int,
                         device=None) -> torch.Tensor:
    """round(linspace(0, T-1, T//α)), computed on the host in float64: the
    products are exact, so a position half-way between two frames rounds
    to the even one. (The JAX package's float32 linspace lands such halves
    an ulp to either side; the two agree everywhere else, which covers
    every (NUM_FRAMES, ALPHA) of the config zoo.)"""
    n = num_frames // alpha
    pos = np.arange(n) * (num_frames - 1) / max(n - 1, 1)
    idx = np.clip(np.round(pos), 0, num_frames - 1).astype(np.int64)
    return torch.from_numpy(idx).to(device, non_blocking=True)


def pack_pathway_output_in_the_middle(cfg, frames: torch.Tensor):
    """Variant selecting the middle T//α frames for the slow pathway
    (reference: datasets/utils.py:115-148)."""
    if cfg.MODEL.ARCH in cfg.MODEL.SINGLE_PATHWAY_ARCH:
        return [frames]
    t = frames.shape[1]
    n_slow = t // cfg.SLOWFAST.ALPHA
    start = (t - n_slow) // 2
    return [frames[:, start: start + n_slow].contiguous(), frames]


def pack_pathway_output(cfg, frames: torch.Tensor):
    """frames (B, T, H, W, C) → [slow, fast] or [frames] per cfg.MODEL.ARCH.

    DATA.SLOW_PATHWAY_MIDDLE selects the contiguous-middle-window slow
    pathway used by the frame-folder pipelines (reference utils.py:115-148).
    """
    if cfg.MODEL.ARCH in cfg.MODEL.SINGLE_PATHWAY_ARCH:
        return [frames]
    if cfg.DATA.SLOW_PATHWAY_MIDDLE:
        return pack_pathway_output_in_the_middle(cfg, frames)
    if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH:
        idx = slow_pathway_indices(frames.shape[1], cfg.SLOWFAST.ALPHA,
                                   frames.device)
        return [torch.index_select(frames, 1, idx), frames]
    raise NotImplementedError(
        f"Model arch {cfg.MODEL.ARCH} is not in "
        f"{cfg.MODEL.SINGLE_PATHWAY_ARCH + cfg.MODEL.MULTI_PATHWAY_ARCH}"
    )
