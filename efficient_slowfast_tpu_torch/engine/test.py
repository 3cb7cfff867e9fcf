"""Multi-view testing engine (port of ``engine/test.py:58-156``; reference:
tools/test_net.py:21-189).

Each video appears NUM_ENSEMBLE_VIEWS × NUM_SPATIAL_CROPS times in the test
set; per-clip post-softmax scores are ensembled per video (sum or max) in
the TestMeter, then top-1/top-k computed. Per batch: the loader's canvas is
copied to the card ahead of time (``prefetch_to_device``), the preprocess
crops, normalizes and packs the pathways there in the compute dtype, the
forward (``make_forward``: the fused engine with K1 under
``TPU.FUSED_EVAL``, else the module's own, with K2 in CMDA's fusions)
scores the clips, and the scores come back to the host one batch behind,
so the card is never idle waiting for the meter. With ``DETECTION.ENABLE``
the test is AVA's (``perform_detection_test``): every real box of the
split scored, then the frame mAP; ``DATA.MULTI_LABEL`` gives the
multi-label mAP of the ensembled scores. Across processes each rank scores
its share of the split and every batch's real rows are gathered from all
ranks before the meter (``gather_across_hosts``), so every rank's meter
sees each view once and no padded row.
"""

from __future__ import annotations


import numpy as np
import torch

from ..data.loader import construct_loader, prefetch_to_device
from ..data.preprocess import make_detection_preprocess, make_test_preprocess
from ..models import build_model
from ..models.build import get_compute_dtype, resolve_device
from ..parallel import distributed
from ..utils.checkpoint import load_test_checkpoint
from ..utils.logging import get_logger, setup_logging
from ..utils.meters import AVAMeter, TestMeter, span
from .state import make_detection_forward, make_forward

logger = get_logger(__name__)


def gather_across_hosts(*arrays):
    """Every process's per-clip eval rows, concatenated in rank order
    (JAX: engine/test.py:28-55; the reference's all_gather_unaligned,
    distributed.py:155-255): the ranks' row counts differ where each drops
    its own padded rows. The identity on one process."""
    return distributed.all_gather_unaligned(*arrays)


def _to_host(t: torch.Tensor):
    """(float32 host copy of ``t``, the event its copy ends at): a CUDA
    tensor is copied into pinned memory without waiting."""
    t = t.float()
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=torch.float32, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def perform_test(cfg, model, loader, meter, device=None, times=None):
    """Score every clip of ``loader`` with ``model`` on ``device`` (the GPU
    by default) into ``meter``; returns its final stats. ``times``
    (``utils.meters.StageTimes``), where given, records each batch's wait
    on the loader and the spans of its copy, preprocess and forward."""
    dev = resolve_device(device)
    preprocess = make_test_preprocess(cfg, get_compute_dtype(cfg))
    fwd = make_forward(cfg, model, dev)

    def ensemble(preds, done, batch):
        if done is not None:
            done.synchronize()
        preds = preds.numpy()
        labels = batch["label"].numpy()
        # spatial_idx never left the host: the clip ids need no read-back
        clip_ids = (batch["index"].numpy() * meter.num_clips
                    + batch["temporal_idx"].numpy() * cfg.TEST.NUM_SPATIAL_CROPS
                    + batch["spatial_idx"].numpy())
        if "_valid" in batch:
            # drop loader padding (pad_to_full mask) before ensembling
            keep = batch["_valid"].numpy() > 0
            preds, labels, clip_ids = preds[keep], labels[keep], clip_ids[keep]
        meter.update_stats(*gather_across_hosts(preds, labels, clip_ids))

    meter.iter_tic()
    pending = None
    for cur_iter, batch in enumerate(prefetch_to_device(
            loader, dev, depth=cfg.DATA_LOADER.PREFETCH_DEPTH, times=times)):
        with span(times, "preprocess", dev):
            inputs = preprocess(batch["frames"], batch["width"],
                                batch["spatial_idx"], batch["portrait"])
        with span(times, "forward", dev):
            preds = fwd(inputs)
        del inputs
        host = _to_host(preds)
        if pending is not None:
            ensemble(*pending)
        pending = host + (batch,)
        if (cur_iter + 1) % cfg.LOG_PERIOD == 0:
            meter.log_iter_stats(cur_iter)
    if pending is not None:
        ensemble(*pending)
    meter.iter_toc()
    return meter.finalize_metrics(ks=(1, cfg.TRAIN.TOPK))


def test(cfg, device=None):
    """The 30-view test of ``cfg`` on ``device`` (the GPU by default):
    the model built with weights seeded by RNG_SEED, its test checkpoint
    loaded, every clip of the test split scored. Returns the finished
    TestMeter: its ``stats`` and per-video ``video_preds``; for detection
    the finished AVAMeter (its mAP in ``full_map``)."""
    setup_logging(cfg.OUTPUT_DIR)
    logger.info("Test with config:\n%s", cfg.dump())
    dev = resolve_device(device)
    torch.manual_seed(cfg.RNG_SEED)
    model = build_model(cfg, dev)
    load_test_checkpoint(cfg, model)
    distributed.verify_state_consistency(model)
    if cfg.TPU.INT8_EVAL:
        int8_calibration(cfg, model, dev)
    loader = construct_loader(cfg, "test")
    if cfg.DETECTION.ENABLE:
        meter = AVAMeter(len(loader), cfg, mode="test")
        meter.video_idx_to_name = loader.dataset._video_idx_to_name
        perform_detection_test(cfg, model, loader, meter, dev)
        meter.finalize_metrics()
        return meter

    num_clips = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    num_items = len(loader.dataset)
    assert num_items % num_clips == 0, (
        f"test set size {num_items} not divisible by {num_clips} views"
    )
    meter = TestMeter(
        num_videos=num_items // num_clips,
        num_clips=num_clips,
        num_cls=cfg.MODEL.NUM_CLASSES,
        overall_iters=len(loader),
        multi_label=cfg.DATA.MULTI_LABEL,
        ensemble_method=cfg.DATA.ENSEMBLE_METHOD,
        topk=cfg.TRAIN.TOPK,
    )
    perform_test(cfg, model, loader, meter, dev)
    return meter


def int8_calibration(cfg, model, device) -> None:
    """Give ``model``'s int8 convs their ranges: the persisted calibration
    where one matches this model and config, else a calibration on the
    first ``TPU.INT8_CALIB_BATCHES`` test batches, persisted for the next
    run (``engine/test.py:118-135`` there: calibrate once, serve many).
    Across processes the ranges are the maxima over every rank's batches,
    the global batches', and the master persists them."""
    from .quantize import (calibrate_for_test, load_calibration,
                           load_quant_state, save_calibration)

    quant = load_calibration(cfg, model)
    if quant is not None:
        load_quant_state(model, quant)
        logger.info("TPU.INT8_EVAL: loaded persisted calibration")
        return
    logger.info("TPU.INT8_EVAL: calibrating activation ranges on %d test "
                "batch(es)", max(1, cfg.TPU.INT8_CALIB_BATCHES))
    quant = calibrate_for_test(cfg, model, device)
    if distributed.world_size() > 1:
        for v in quant.values():
            torch.distributed.all_reduce(v, op=torch.distributed.ReduceOp.MAX)
        load_quant_state(model, quant)
    if distributed.is_master():
        path = save_calibration(cfg, model, quant)
        logger.info("TPU.INT8_EVAL: persisted calibration to %s", path)


def detection_box_mask(batch) -> np.ndarray:
    """Flat (B·MAX,) bool mask of the real boxes of a detection eval batch:
    ``box_mask`` and the loader's per-clip ``_valid``, which drops the
    clips that pad the tail batch (their boxes would count twice)."""
    m = np.asarray(batch["box_mask"]) > 0  # (B, MAX)
    if "_valid" in batch:
        m = m & (np.asarray(batch["_valid"]).reshape(-1, 1) > 0)
    return m.reshape(-1)


def perform_detection_test(cfg, model, loader, meter, device=None,
                           times=None, cur_epoch=None):
    """Score every real box of ``loader`` (AVA) with ``model`` on
    ``device`` (the GPU by default) into ``meter`` (an ``AVAMeter``), as
    ``perform_test`` does a clip's: the canvas copied ahead, normalized and
    packed on the card with no crop (the boxes are in canvas pixels), the
    scores read back one batch behind. ``times`` as ``perform_test``'s."""
    dev = resolve_device(device)
    preprocess = make_detection_preprocess(cfg, get_compute_dtype(cfg))
    fwd = make_detection_forward(cfg, model, dev)

    def collect(preds, done, batch):
        if done is not None:
            done.synchronize()
        m = detection_box_mask(batch)
        ori = batch["ori_boxes"].numpy().reshape(-1, 4)[m]
        meta = np.repeat(batch["metadata"].numpy(), batch["boxes"].shape[1],
                         axis=0)[m]
        ori5 = np.concatenate([np.zeros((len(ori), 1)), ori], axis=1)
        meter.update_stats(*gather_across_hosts(preds.numpy()[m], ori5, meta))

    meter.iter_tic()
    pending = None
    for cur_iter, batch in enumerate(prefetch_to_device(
            loader, dev, depth=cfg.DATA_LOADER.PREFETCH_DEPTH, times=times)):
        with span(times, "preprocess", dev):
            inputs = preprocess(batch["frames"])
        with span(times, "forward", dev):
            preds = fwd(inputs, batch["boxes"])
        del inputs
        host = _to_host(preds)
        if pending is not None:
            collect(*pending)
        pending = host + (batch,)
        meter.log_iter_stats(cur_epoch, cur_iter)
    if pending is not None:
        collect(*pending)
    meter.iter_toc()
    return meter
