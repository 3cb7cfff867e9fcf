"""Train and val epochs (port of ``engine/train.py:60-173, 382-395``;
reference: tools/train_net.py).

An epoch's step is the train state's own (``engine/state.py``): the
preprocess runs on the card from the copied canvas, and the step's metrics
stay on the card until the host reads them, ``TPU.METRICS_PERIOD`` steps
at a time (the reference reads every step, train_net.py:133-138). The rest
of ``train()`` — the epoch loop, checkpoints, multigrid, precise BN — comes
with ROADMAP item 3.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..data.loader import prefetch_to_device
from ..utils import lr_policy
from ..utils.logging import get_logger
from .test import gather_across_hosts

logger = get_logger(__name__)


def check_nan_losses(loss: float):
    """reference: utils/misc.py:26-33."""
    if math.isnan(loss):
        raise RuntimeError("ERROR: Got NaN losses")


def step_generator(seed: int, counter: int, device) -> torch.Generator:
    """A generator on ``device`` for one step's preprocess draws, seeded by
    (seed, counter) as the JAX package folds the step's counter into its
    key (``jax.random.fold_in``)."""
    state = np.random.SeedSequence([seed, counter]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _model_device(state) -> torch.device:
    return next(state.model.parameters()).device


def train_epoch(cfg, state, train_step, preprocess, loader, meter, cur_epoch,
                generator=None, writer=None):
    """One epoch of ``train_step`` (``make_train_step``) over ``loader`` on
    the train state's device; ``preprocess`` is ``make_train_preprocess``'s,
    its draws from ``step_generator(RNG_SEED, epoch·iters + iter)``;
    ``generator`` feeds the head's dropout. Returns the state, updated in
    place."""
    if cfg.MULTIGRID.SHORT_CYCLE:
        raise NotImplementedError(
            "MULTIGRID.SHORT_CYCLE comes with the train loop, ROADMAP item 3")
    dev = _model_device(state)
    data_size = len(loader)
    meter.iter_tic()
    pending = []  # (iter, batch size, metrics on the card)
    for cur_iter, batch in enumerate(prefetch_to_device(
            loader, dev, depth=cfg.DATA_LOADER.PREFETCH_DEPTH)):
        lr = lr_policy.get_lr_at_epoch(cfg, cur_epoch + float(cur_iter) / data_size)
        gen = step_generator(cfg.RNG_SEED, cur_epoch * data_size + cur_iter,
                             dev)
        inputs = preprocess(gen, batch["frames"], batch["width"],
                            batch.get("portrait"), batch.get("crop_u"))
        labels = batch["label"]
        mets = train_step(state, inputs, labels, lr, generator)
        pending.append((cur_iter, labels.shape[0], mets))
        if len(pending) >= cfg.TPU.METRICS_PERIOD or cur_iter == data_size - 1:
            for it, bs, m in pending:
                m = {k: float(v) for k, v in m.items()}
                loss = m["loss"]
                check_nan_losses(loss)
                meter.update_stats(
                    m.get("top1_err", 0.0),
                    m.get(f"top{cfg.TRAIN.TOPK}_err", 0.0),
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
    the epoch's top-1 error."""
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
        if plot:
            keep = slice(None) if valid is None else valid.numpy() > 0
            all_preds.append(out["preds"].float().cpu().numpy()[keep])
            all_labels.append(labels.numpy()[keep])
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
