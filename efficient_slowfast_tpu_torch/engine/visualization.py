"""Model-input visualization (port of ``engine/visualization.py``;
reference: tools/visualization.py:19-110).

For TENSORBOARD.MODEL_VIS jobs: every clip of the test loader, through the
test preprocess and de-normalized, goes to TensorBoard as a video a
pathway and batch, the loader's pad rows left out. Across processes each
batch's clips are gathered from every rank (JAX:
engine/visualization.py:39-53) and the master writes them. Grad-CAM is
the standalone tool (tools/gradcam_video.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.loader import construct_loader, prefetch_to_device
from ..data.preprocess import make_test_preprocess
from ..models import build_model
from ..models.build import resolve_device
from ..parallel import distributed
from ..utils.checkpoint import load_test_checkpoint
from ..utils.logging import get_logger, setup_logging
from ..visualization.tensorboard_vis import TensorboardWriter
from .test import gather_across_hosts

logger = get_logger(__name__)


def visualize(cfg, device=None):
    """Write the test split's input clips of ``cfg`` to TensorBoard, the
    model built and its test checkpoint loaded on ``device`` (the GPU by
    default), as the reference tool does."""
    setup_logging(cfg.OUTPUT_DIR)
    dev = resolve_device(device)
    torch.manual_seed(cfg.RNG_SEED)
    model = build_model(cfg, dev)
    load_test_checkpoint(cfg, model)
    del model

    loader = construct_loader(cfg, "test")
    preprocess = make_test_preprocess(cfg)
    writer = TensorboardWriter(cfg) if distributed.is_master() else None
    mean, std = np.asarray(cfg.DATA.MEAN), np.asarray(cfg.DATA.STD)
    for step, batch in enumerate(prefetch_to_device(
            loader, dev, depth=cfg.DATA_LOADER.PREFETCH_DEPTH)):
        inputs = preprocess(batch["frames"], batch["width"],
                            batch["spatial_idx"], batch.get("portrait"))
        keep = (batch["_valid"].numpy() > 0 if "_valid" in batch
                else slice(None))  # the loader's pad rows stay out
        clips = gather_across_hosts(
            *[x.float().cpu().numpy()[keep] for x in inputs])
        if writer is None:
            continue
        for p, video in enumerate(clips):
            writer.add_video(np.clip(video * std + mean, 0.0, 1.0),
                             tag=f"Video Input Pathway {p}", global_step=step)
    if writer is not None:
        writer.close()
    logger.info("Visualization written.")
