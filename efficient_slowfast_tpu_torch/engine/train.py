"""Training engine (port of ``engine/train.py``; reference:
tools/train_net.py).

``train(cfg)`` runs the epochs: the multigrid schedule (long-cycle phases,
each with its loaders, steps and meters, the model rebuilt where the BN
type changes; short-cycle crops and batches step by step), precise BN, the
checkpoint and eval cadence, and auto-resume. An epoch's step is the train
state's own (``engine/state.py``): the preprocess runs on the card from the
copied canvas, and the step's metrics stay on the card until the host
reads them, ``TPU.METRICS_PERIOD`` steps at a time (the reference reads
every step, train_net.py:133-138). Every draw is seeded by RNG_SEED and
the step or epoch it belongs to, so a resumed run repeats the one it
resumes. With ``DETECTION.ENABLE`` the epochs are AVA's
(``_train_detection``): the detection step over padded boxes and a val
frame mAP. Across processes every rank runs this loop on its share of
each global batch: the steps' metrics are global, the master writes the
checkpoints and the TensorBoard events, the val rows are gathered, and
the ranks meet at ``host_barrier("train_complete")`` before a test reads
the master's last checkpoint (JAX: engine/train.py:297-301).
"""

from __future__ import annotations

import random

import numpy as np
import torch

from ..data.loader import (construct_loader, prefetch_to_device,
                           shuffle_dataset)
from ..data.preprocess import (make_detection_train_preprocess,
                               make_train_preprocess)
from ..models import build_model
from ..models.build import get_compute_dtype, resolve_device
from ..ops.norm import (aggregate_sub_bn_stats, convert_bn_stats,
                        effective_num_splits, effective_sync_groups)
from ..parallel import distributed
from ..utils import checkpoint as cu
from ..utils import lr_policy
from ..utils.logging import get_logger, is_master, setup_logging
from ..utils.meters import AVAMeter, TrainMeter, ValMeter
from ..utils.misc import check_nan_losses, log_model_info
from ..utils.multigrid import MultigridSchedule, short_cycle_shapes
from .precise_bn import calculate_and_update_precise_bn
from .state import (_model_device, create_train_state,
                    make_detection_train_step, make_eval_step,
                    make_train_step, pathway_inputs, step_generator)
from .test import gather_across_hosts, perform_detection_test

logger = get_logger(__name__)

def train_epoch(cfg, state, train_step, preprocess, loader, meter, cur_epoch,
                generator=None, writer=None):
    """One epoch of ``train_step`` (``make_train_step``) over ``loader`` on
    the train state's device; ``preprocess`` is ``make_train_preprocess``'s,
    its draws from ``step_generator(RNG_SEED, epoch·iters + iter)``;
    ``generator`` feeds the head's dropout. Under ``MULTIGRID.SHORT_CYCLE``
    each batch is cropped to its phase's size (``_phase``, from the loader's
    schedule) instead. Returns the state, updated in place."""
    dev = _model_device(state)
    short_cycle = None
    if cfg.MULTIGRID.SHORT_CYCLE:
        short_cycle = [make_train_preprocess(cfg, get_compute_dtype(cfg), s)
                       for s in short_cycle_shapes(cfg)]
    data_size = len(loader)
    meter.iter_tic()
    pending = []  # (iter, batch size, metrics on the card)
    for cur_iter, batch in enumerate(prefetch_to_device(
            loader, dev, depth=cfg.DATA_LOADER.PREFETCH_DEPTH)):
        lr = lr_policy.get_lr_at_epoch(cfg, cur_epoch + float(cur_iter) / data_size)
        gen = step_generator(cfg.RNG_SEED, cur_epoch * data_size + cur_iter,
                             dev)
        pre = preprocess
        if short_cycle is not None:
            if "_phase" not in batch:
                raise ValueError("MULTIGRID.SHORT_CYCLE: the loader's batches "
                                 "carry no short-cycle phase (_phase)")
            pre = short_cycle[int(batch["_phase"])]
        inputs = pre(gen, batch["frames"], batch["width"],
                     batch.get("portrait"), batch.get("crop_u"))
        labels = batch["label"]
        mets = train_step(state, inputs, labels, lr, generator)
        pending.append((cur_iter, labels.shape[0] * distributed.data_size(),
                        mets))
        if len(pending) >= cfg.TPU.METRICS_PERIOD or cur_iter == data_size - 1:
            for it, bs, m in pending:
                m = {k: float(v) for k, v in m.items()}
                loss = m["loss"]
                check_nan_losses(loss)
                # a multi-label step has no top-k errors: None
                meter.update_stats(
                    m.get("top1_err"), m.get(f"top{cfg.TRAIN.TOPK}_err"),
                    loss, m["lr"], bs,
                )
                meter.log_iter_stats(cur_epoch, it)
                if writer is not None:
                    writer.add_scalars(
                        {
                            "Train/loss": loss,
                            "Train/lr": m["lr"],
                            "Train/Top1_err": m.get("top1_err", 0.0),
                            "Train/Top5_err": m.get(
                                f"top{cfg.TRAIN.TOPK}_err", 0.0),
                        },
                        global_step=data_size * cur_epoch + it,
                    )
            pending = []
    meter.iter_toc()
    meter.log_epoch_stats(cur_epoch)
    meter.reset()
    return state


def eval_epoch(cfg, state, eval_step, preprocess, loader, meter, cur_epoch,
               writer=None):
    """One val epoch of ``eval_step`` (``make_eval_step``) over ``loader``;
    the loader's padding (``_valid``) is left out of the errors. Returns
    the epoch's top-1 error; with ``DATA.MULTI_LABEL``, the mAP of its
    clips' scores."""
    dev = _model_device(state)
    # per-clip rows are kept when plotting is configured (the writer plots
    # the whole val set)
    plot = cfg.TENSORBOARD.ENABLE and (
        cfg.TENSORBOARD.CONFUSION_MATRIX.ENABLE or cfg.TENSORBOARD.HISTOGRAM.ENABLE
    )
    all_preds, all_labels = [], []
    meter.iter_tic()
    for cur_iter, batch in enumerate(prefetch_to_device(
            loader, dev, depth=cfg.DATA_LOADER.PREFETCH_DEPTH)):
        labels = batch["label"]
        valid = batch.get("_valid")  # host mask (loader pad_to_full)
        inputs = preprocess(step_generator(cfg.RNG_SEED, cur_iter, dev),
                            batch["frames"], batch["width"],
                            batch.get("portrait"), batch.get("crop_u"))
        out = eval_step(state, inputs, labels, valid)
        keep = slice(None) if valid is None else valid.numpy() > 0
        if plot or cfg.DATA.MULTI_LABEL:
            preds = out["preds"].float().cpu().numpy()[keep]
            rows = labels.numpy()[keep]
        if plot:
            all_preds.append(preds)
            all_labels.append(rows)
        if cfg.DATA.MULTI_LABEL:
            meter.update_predictions(*gather_across_hosts(preds, rows))
        else:
            meter.update_stats(
                float(out["top1_err"]),
                float(out[f"top{cfg.TRAIN.TOPK}_err"]),
                float(out["num_valid"]),
            )
        meter.log_iter_stats(cur_epoch, cur_iter)
    meter.iter_toc()
    top1 = meter.log_epoch_stats(cur_epoch)
    meter.reset()
    if plot and all_preds:
        preds, labels = gather_across_hosts(
            np.concatenate(all_preds), np.concatenate(all_labels))
        if writer is not None:
            writer.plot_eval(preds, labels, global_step=cur_epoch)
    return top1


def _bn_signature(cfg):
    """(norm type, groups) that decides whether the model must be rebuilt
    at a multigrid phase boundary (JAX: engine/train.py:42-57): sync-BN of
    one group is plain BN (``get_norm``), so it takes plain BN's
    signature."""
    norm = cfg.BN.NORM_TYPE
    if norm == "sub_batchnorm":
        return (norm, cfg.BN.NUM_SPLITS)
    if norm == "sync_batchnorm":
        groups = effective_sync_groups(cfg)
        if groups > 1:
            return (norm, groups)
    return ("batchnorm", 0)


def _rebuild(cfg, state, old_bn: str, new_bn: str, device):
    """A train state of the model built for ``cfg``'s BN type, holding
    ``state``'s parameters and optimizer state and its BN statistics
    converted to the new form (``convert_bn_stats``)."""
    logger.info("multigrid BN rebuild: %s -> %s", old_bn, new_bn)
    stats = convert_bn_stats(state.model.state_dict(), old_bn, new_bn,
                             effective_num_splits(cfg))
    model = build_model(cfg, device)
    model.load_state_dict(stats, strict=True)
    new = create_train_state(cfg, model, device)
    cu.load_optimizer_state(new.optimizer, state.optimizer.state_dict())
    new.step = state.step
    return new


def _phase_parts(cfg, state):
    """The loaders, steps, preprocess and meters of the current shape."""
    train_loader = construct_loader(cfg, "train")
    val_loader = construct_loader(cfg, "val")
    return dict(
        train_loader=train_loader, val_loader=val_loader,
        precise_loader=(construct_loader(cfg, "train")
                        if cfg.BN.USE_PRECISE_STATS else None),
        train_step=make_train_step(cfg, state.model, state.optimizer),
        eval_step=make_eval_step(cfg, state.model),
        preprocess=make_train_preprocess(cfg, get_compute_dtype(cfg)),
        train_meter=TrainMeter(len(train_loader), cfg),
        val_meter=ValMeter(len(val_loader), cfg))


def detection_train_epoch(cfg, state, train_step, preprocess, loader, meter,
                          cur_epoch, generator=None):
    """One AVA epoch of ``train_step`` (``make_detection_train_step``) over
    ``loader``: the canvas copied ahead, the train preprocess
    (``make_detection_train_preprocess``) drawing from
    ``step_generator(RNG_SEED, epoch·iters + iter)``, the boxes carried
    through its crop and flip; the losses read back
    ``TPU.METRICS_PERIOD`` steps at a time. Returns the state."""
    dev = _model_device(state)
    data_size = len(loader)
    meter.iter_tic()
    pending = []  # (iter, metrics on the card)
    for cur_iter, batch in enumerate(prefetch_to_device(
            loader, dev, depth=cfg.DATA_LOADER.PREFETCH_DEPTH)):
        lr = lr_policy.get_lr_at_epoch(cfg, cur_epoch + float(cur_iter) / data_size)
        gen = step_generator(cfg.RNG_SEED, cur_epoch * data_size + cur_iter,
                             dev)
        inputs, boxes = preprocess(gen, batch["frames"], batch["width"],
                                   batch["boxes"])
        pending.append((cur_iter, train_step(
            state, inputs, boxes, batch["box_labels"], batch["box_mask"], lr,
            generator)))
        if len(pending) >= cfg.TPU.METRICS_PERIOD or cur_iter == data_size - 1:
            for it, m in pending:
                loss = float(m["loss"])
                check_nan_losses(loss)
                meter.update_stats(None, None, None, loss=loss,
                                   lr=float(m["lr"]))
                meter.log_iter_stats(cur_epoch, it)
            pending = []
    meter.iter_toc()
    meter.reset()
    return state


def _train_detection(cfg, state, start_epoch, device):
    """AVA's epochs from ``start_epoch`` (reference train_net.py, the
    detection branch): a checkpoint each ``is_checkpoint_epoch``, the val
    split's frame mAP each ``_is_eval_epoch``. Returns the state."""
    train_loader = construct_loader(cfg, "train")
    val_loader = construct_loader(cfg, "val")
    step = make_detection_train_step(cfg, state.model, state.optimizer)
    preprocess = make_detection_train_preprocess(cfg, get_compute_dtype(cfg))
    train_meter = AVAMeter(len(train_loader), cfg, mode="train")
    val_meter = AVAMeter(len(val_loader), cfg, mode="val")
    val_meter.video_idx_to_name = val_loader.dataset._video_idx_to_name
    for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
        shuffle_dataset(train_loader, cur_epoch)
        detection_train_epoch(
            cfg, state, step, preprocess, train_loader, train_meter,
            cur_epoch, generator=step_generator(cfg.RNG_SEED, cur_epoch,
                                                device, stream=1))
        if cu.is_checkpoint_epoch(cfg, cur_epoch):
            cu.save_checkpoint(cfg.OUTPUT_DIR, state, cur_epoch, cfg)
        if _is_eval_epoch(cfg, cur_epoch):
            perform_detection_test(cfg, state.model, val_loader, val_meter,
                                   device, cur_epoch=cur_epoch)
            val_meter.log_epoch_stats(cur_epoch)
            val_meter.reset()
    cu.wait_for_saves()  # drain the in-flight async (.dcp) checkpoint
    distributed.host_barrier("train_complete")
    return state


def train(cfg, device=None):
    """Train ``cfg``'s model on ``device`` (the GPU by default) from its
    last checkpoint (``TRAIN.AUTO_RESUME``), ``TRAIN.CHECKPOINT_FILE_PATH``
    or the seeded init, to ``SOLVER.MAX_EPOCH``; ``cfg`` takes the
    multigrid schedule's solver and shapes, as in the reference. Returns
    the final train state."""
    setup_logging(cfg.OUTPUT_DIR)
    logger.info("Train with config:\n%s", cfg.dump())
    dev = resolve_device(device)
    np.random.seed(cfg.RNG_SEED)
    random.seed(cfg.RNG_SEED)
    torch.manual_seed(cfg.RNG_SEED)

    multigrid = None
    if cfg.MULTIGRID.LONG_CYCLE or cfg.MULTIGRID.SHORT_CYCLE:
        multigrid = MultigridSchedule()
        cfg = multigrid.init_multigrid(cfg)
        if cfg.MULTIGRID.LONG_CYCLE:
            cfg, _ = multigrid.update_long_cycle(cfg, cur_epoch=0)
    schedule = multigrid.schedule if multigrid else None

    state = create_train_state(cfg, build_model(cfg, dev), dev)
    state, start_epoch = cu.load_train_checkpoint(cfg, state)
    # every rank restored the same state (a torn read would diverge)
    distributed.verify_state_consistency(state.model)
    if cfg.LOG_MODEL_INFO:
        log_model_info(state.model, cfg, pathway_inputs(
            cfg, 1, get_compute_dtype(cfg), dev))
    if cfg.DETECTION.ENABLE:
        return _train_detection(cfg, state, start_epoch, dev)
    cur_bn = _bn_signature(cfg)
    phase = _phase_parts(cfg, state)
    writer = None
    if cfg.TENSORBOARD.ENABLE and is_master():
        from ..visualization.tensorboard_vis import TensorboardWriter

        writer = TensorboardWriter(cfg)

    logger.info("Start epoch: %d", start_epoch + 1)
    for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
        if multigrid is not None and cfg.MULTIGRID.LONG_CYCLE:
            cfg, changed = multigrid.update_long_cycle(cfg, cur_epoch)
            if changed:
                new_bn = _bn_signature(cfg)
                if new_bn != cur_bn:
                    state = _rebuild(cfg, state, cur_bn[0], new_bn[0], dev)
                    cur_bn = new_bn
                phase = _phase_parts(cfg, state)

        shuffle_dataset(phase["train_loader"], cur_epoch)
        train_epoch(cfg, state, phase["train_step"], phase["preprocess"],
                    phase["train_loader"], phase["train_meter"], cur_epoch,
                    generator=step_generator(cfg.RNG_SEED, cur_epoch, dev,
                                             stream=1), writer=writer)
        if phase["precise_loader"] is not None:
            calculate_and_update_precise_bn(
                cfg, state, phase["precise_loader"], phase["preprocess"],
                min(cfg.BN.NUM_BATCHES_PRECISE, len(phase["precise_loader"])))
        if cfg.BN.NORM_TYPE == "sub_batchnorm":
            aggregate_sub_bn_stats(state.model)

        if cu.is_checkpoint_epoch(cfg, cur_epoch, schedule):
            cu.save_checkpoint(cfg.OUTPUT_DIR, state, cur_epoch, cfg)
        if _is_eval_epoch(cfg, cur_epoch, schedule):
            top1 = eval_epoch(cfg, state, phase["eval_step"],
                              phase["preprocess"], phase["val_loader"],
                              phase["val_meter"], cur_epoch, writer=writer)
            if writer is not None:
                writer.add_scalars({"Val/Top1_err": top1},
                                   global_step=cur_epoch)
    if writer is not None:
        writer.close()
    cu.wait_for_saves()  # drain the in-flight async (.dcp) checkpoint
    distributed.host_barrier("train_complete")
    return state


def _is_eval_epoch(cfg, cur_epoch, multigrid_schedule=None) -> bool:
    """reference: utils/misc.py:193-214."""
    if cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH:
        return True
    if multigrid_schedule is not None:
        prev_epoch = 0
        for s in multigrid_schedule:
            if cur_epoch < s[-1]:
                period = max(
                    (s[-1] - prev_epoch) // cfg.MULTIGRID.EVAL_FREQ + 1, 1
                )
                return (s[-1] - 1 - cur_epoch) % period == 0
            prev_epoch = s[-1]
    return (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0
