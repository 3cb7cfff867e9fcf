"""TensorBoard logging (port of ``visualization/tensorboard_vis.py``;
reference: slowfast/visualization/tensorboard_vis.py).

Scalars per iteration, the confusion matrix and per-class top-k histograms
at an eval epoch's end, video grids; through
``torch.utils.tensorboard.SummaryWriter`` (the ``tensorboard`` package is
imported when a writer is made). Only the master process writes.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..utils.logging import get_logger, is_master
from . import utils as vis_utils

logger = get_logger(__name__)


class TensorboardWriter:
    """Events under TENSORBOARD.LOG_DIR, or OUTPUT_DIR/runs-<TRAIN.DATASET>;
    every method is a no-op outside the master process."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.writer = None
        if not is_master():
            return
        log_dir = cfg.TENSORBOARD.LOG_DIR or os.path.join(
            cfg.OUTPUT_DIR, f"runs-{cfg.TRAIN.DATASET}")
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=log_dir)
        self.log_dir = log_dir
        logger.info("TensorBoard events at %s", log_dir)

        self.class_names = self.parent_map = self.subset = None
        if cfg.TENSORBOARD.CLASS_NAMES_PATH:
            from ..utils.misc import get_class_names

            self.class_names, self.parent_map, self.subset = get_class_names(
                cfg.TENSORBOARD.CLASS_NAMES_PATH,
                cfg.TENSORBOARD.CATEGORIES_PATH or None,
                cfg.TENSORBOARD.HISTOGRAM.SUBSET_PATH or None)

    def add_scalars(self, data_dict: Dict[str, float],
                    global_step: Optional[int] = None):
        """Each int or float of ``data_dict`` as a scalar under its key."""
        if self.writer is None:
            return
        for key, item in data_dict.items():
            if isinstance(item, (int, float)):
                self.writer.add_scalar(key, item, global_step)

    def plot_eval(self, preds: np.ndarray, labels: np.ndarray,
                  global_step: Optional[int] = None):
        """The confusion matrix and the per-class top-k histograms of an
        eval epoch's score rows (reference :89-186), each where the cfg
        enables it."""
        if self.writer is None:
            return
        cfg = self.cfg
        if cfg.TENSORBOARD.CONFUSION_MATRIX.ENABLE:
            cm = vis_utils.get_confusion_matrix(preds, labels,
                                                cfg.MODEL.NUM_CLASSES)
            fig = vis_utils.plot_confusion_matrix(
                cm, cfg.MODEL.NUM_CLASSES, self.class_names,
                figsize=cfg.TENSORBOARD.CONFUSION_MATRIX.FIGSIZE)
            self.writer.add_figure("Confusion Matrix", fig, global_step)
        if cfg.TENSORBOARD.HISTOGRAM.ENABLE:
            cm = vis_utils.get_confusion_matrix(preds, labels,
                                                cfg.MODEL.NUM_CLASSES)
            classes = (self.subset if self.subset is not None
                       else range(cfg.MODEL.NUM_CLASSES))
            for i in classes:
                fig = vis_utils.plot_topk_histogram(
                    i, cm[int(i)], cfg.TENSORBOARD.HISTOGRAM.TOPK,
                    self.class_names,
                    figsize=cfg.TENSORBOARD.HISTOGRAM.FIGSIZE)
                self.writer.add_figure(f"Top-k error {i}", fig, global_step)

    def add_video(self, vid_tensor: np.ndarray, tag: str = "Video Input",
                  global_step: Optional[int] = None, fps: int = 4):
        """``vid_tensor`` (B, T, H, W, C), float in [0, 1], as a grid."""
        if self.writer is None:
            return
        import torch

        v = torch.tensor(np.asarray(vid_tensor)).permute(0, 1, 4, 2, 3)
        self.writer.add_video(tag, v, global_step=global_step, fps=fps)

    def flush(self):
        if self.writer is not None:
            self.writer.flush()

    def close(self):
        if self.writer is not None:
            self.writer.flush()
            self.writer.close()
