"""Multigrid training schedules (port of ``utils/multigrid.py``; reference:
slowfast/utils/multigrid.py and datasets/multigrid_helper.py).

Long cycle: the epochs of each (B, T, S) base shape, matched in
iterations (reference :123-212); each shape is a phase with its own
loaders, steps and meters, and the BN type follows the per-card batch
(:83-101): sub-BN above ``BN_BASE_SIZE`` clips a card, sync-BN below.
Short cycle: the crop size and batch size cycle step by step
(reference multigrid_helper.py:11-79).

The port's ``short_cycle_batch_sizes`` follows the reference's
``ShortCycleBatchSampler``: B times an integer factor, the rounded
(S / s)². The JAX package rounds B·(S/s)², which on one card gives
batches such as 1019 that no sub-BN split count divides.
"""

from __future__ import annotations

import numpy as np

from .logging import get_logger

logger = get_logger(__name__)


class MultigridSchedule:
    """Long-cycle schedule generation and the per-epoch shape update."""

    def __init__(self):
        self.schedule = None

    def init_multigrid(self, cfg):
        """Record the default (B, T, S) and rewrite the solver's steps,
        relative lrs and epochs for the schedule, in place; returns cfg."""
        self.schedule = None
        cfg.MULTIGRID.DEFAULT_B = cfg.TRAIN.BATCH_SIZE
        cfg.MULTIGRID.DEFAULT_T = cfg.DATA.NUM_FRAMES
        cfg.MULTIGRID.DEFAULT_S = cfg.DATA.TRAIN_CROP_SIZE

        if cfg.MULTIGRID.LONG_CYCLE:
            self.schedule = self.get_long_cycle_schedule(cfg)
            cfg.SOLVER.STEPS = [0] + [s[-1] for s in self.schedule]
            # fine-tuning phase boundary
            cfg.SOLVER.STEPS[-1] = (cfg.SOLVER.STEPS[-2]
                                    + cfg.SOLVER.STEPS[-1]) // 2
            cfg.SOLVER.LRS = [
                cfg.SOLVER.GAMMA ** s[0] * s[1][0] for s in self.schedule
            ]
            cfg.SOLVER.LRS = cfg.SOLVER.LRS[:-1] + [
                cfg.SOLVER.LRS[-2], cfg.SOLVER.LRS[-1],
            ]
            cfg.SOLVER.MAX_EPOCH = self.schedule[-1][-1]
        elif cfg.MULTIGRID.SHORT_CYCLE:
            cfg.SOLVER.STEPS = [
                int(s * cfg.MULTIGRID.EPOCH_FACTOR) for s in cfg.SOLVER.STEPS
            ]
            cfg.SOLVER.MAX_EPOCH = int(
                cfg.SOLVER.MAX_EPOCH * cfg.MULTIGRID.EPOCH_FACTOR
            )
        return cfg

    def update_long_cycle(self, cfg, cur_epoch):
        """Set ``cur_epoch``'s base shape and BN type in cfg; returns (cfg,
        changed). On a change the trainer rebuilds its loaders and steps."""
        base_b, base_t, base_s = get_current_long_cycle_shape(
            self.schedule, cur_epoch
        )
        if base_s == cfg.DATA.TRAIN_CROP_SIZE and base_t == cfg.DATA.NUM_FRAMES:
            return cfg, False

        cfg.DATA.NUM_FRAMES = base_t
        cfg.DATA.TRAIN_CROP_SIZE = base_s
        cfg.TRAIN.BATCH_SIZE = base_b * cfg.MULTIGRID.DEFAULT_B

        bs_factor = (
            float(cfg.TRAIN.BATCH_SIZE / cfg.NUM_GPUS)
            / cfg.MULTIGRID.BN_BASE_SIZE
        )
        if bs_factor < 1:
            cfg.BN.NORM_TYPE = "sync_batchnorm"
            cfg.BN.NUM_SYNC_DEVICES = int(1.0 / bs_factor)
        elif bs_factor > 1:
            cfg.BN.NORM_TYPE = "sub_batchnorm"
            cfg.BN.NUM_SPLITS = int(bs_factor)
        else:
            cfg.BN.NORM_TYPE = "batchnorm"

        cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE = cfg.DATA.SAMPLING_RATE * (
            cfg.MULTIGRID.DEFAULT_T // cfg.DATA.NUM_FRAMES
        )
        logger.info(
            "Long cycle update: BN=%s B=%d T=%dx%d S=%d",
            cfg.BN.NORM_TYPE, cfg.TRAIN.BATCH_SIZE, cfg.DATA.NUM_FRAMES,
            cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE, cfg.DATA.TRAIN_CROP_SIZE,
        )
        return cfg, True

    def get_long_cycle_schedule(self, cfg):
        """[(step index, [B factor, T, S], cumulative end epoch)]."""
        steps = cfg.SOLVER.STEPS
        default_size = float(cfg.DATA.NUM_FRAMES * cfg.DATA.TRAIN_CROP_SIZE ** 2)
        default_iters = steps[-1]

        avg_bs = []
        all_shapes = []
        for t_factor, s_factor in cfg.MULTIGRID.LONG_CYCLE_FACTORS:
            base_t = int(round(cfg.DATA.NUM_FRAMES * t_factor))
            base_s = int(round(cfg.DATA.TRAIN_CROP_SIZE * s_factor))
            if cfg.MULTIGRID.SHORT_CYCLE:
                shapes = [
                    [base_t,
                     cfg.MULTIGRID.DEFAULT_S * cfg.MULTIGRID.SHORT_CYCLE_FACTORS[0]],
                    [base_t,
                     cfg.MULTIGRID.DEFAULT_S * cfg.MULTIGRID.SHORT_CYCLE_FACTORS[1]],
                    [base_t, base_s],
                ]
            else:
                shapes = [[base_t, base_s]]
            shapes = [
                [int(round(default_size / (s[0] * s[1] * s[1]))), s[0], s[1]]
                for s in shapes
            ]
            avg_bs.append(np.mean([s[0] for s in shapes]))
            all_shapes.append(shapes)

        total_iters = 0.0
        schedule = []
        for step_index in range(len(steps) - 1):
            step_epochs = steps[step_index + 1] - steps[step_index]
            for long_cycle_index, shapes in enumerate(all_shapes):
                cur_epochs = step_epochs * avg_bs[long_cycle_index] / sum(avg_bs)
                cur_iters = cur_epochs / avg_bs[long_cycle_index]
                total_iters += cur_iters
                schedule.append((step_index, shapes[-1], cur_epochs))

        iter_saving = default_iters / total_iters
        final_step_epochs = cfg.SOLVER.MAX_EPOCH - steps[-1]
        # fine-tuning phase with the same iteration saving
        ft_epochs = final_step_epochs / iter_saving * avg_bs[-1]
        schedule.append((step_index + 1, all_shapes[-1][-1], ft_epochs))

        x = (
            cfg.SOLVER.MAX_EPOCH * cfg.MULTIGRID.EPOCH_FACTOR
            / sum(s[-1] for s in schedule)
        )
        final_schedule = []
        total_epochs = 0.0
        for s in schedule:
            epochs = s[2] * x
            total_epochs += epochs
            final_schedule.append((s[0], s[1], int(round(total_epochs))))
        print_schedule(final_schedule)
        return final_schedule


def print_schedule(schedule):
    logger.info("Long cycle index\tBase shape\tEpochs")
    for s in schedule:
        logger.info("%s\t%s\t%s", s[0], s[1], s[2])


def get_current_long_cycle_shape(schedule, epoch):
    """The [B factor, T, S] of ``epoch``."""
    for s in schedule:
        if epoch < s[-1]:
            return s[1]
    return schedule[-1][1]


def short_cycle_shapes(cfg):
    """The 3 crop sizes a short cycle rotates through
    (reference: datasets/multigrid_helper.py:41-58)."""
    default_s = cfg.MULTIGRID.DEFAULT_S or cfg.DATA.TRAIN_CROP_SIZE
    f0, f1 = cfg.MULTIGRID.SHORT_CYCLE_FACTORS
    return [
        int(round(default_s * f0)),
        int(round(default_s * f1)),
        cfg.DATA.TRAIN_CROP_SIZE,
    ]


def short_cycle_batch_sizes(cfg):
    """The batch size of each short-cycle step: B times the rounded
    (S / (f·DEFAULT_S))² of its crop factor f, and B at the base crop, as
    the reference's ShortCycleBatchSampler computes them
    (multigrid_helper.py:41-58). Every size is a multiple of B, so the
    sub-BN splits that divide B divide it."""
    bs = cfg.TRAIN.BATCH_SIZE
    default_s = cfg.MULTIGRID.DEFAULT_S or cfg.DATA.TRAIN_CROP_SIZE
    factors = [
        int(round((float(cfg.DATA.TRAIN_CROP_SIZE) / (f * default_s)) ** 2))
        for f in cfg.MULTIGRID.SHORT_CYCLE_FACTORS
    ]
    return [bs * factors[0], bs * factors[1], bs]
