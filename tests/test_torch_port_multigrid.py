"""The port's multigrid schedules against the JAX package's, for every
config of the zoo that sets MULTIGRID, on the port's and the JAX
package's own config loaders: the long-cycle schedule, the solver it
writes (STEPS, LRS, MAX_EPOCH), each epoch's shape and BN type from
update_long_cycle, the short cycle's crops, and the checkpoint and eval
cadence. The short-cycle batch sizes are the reference sampler's (B times
an integer factor, each divisible by the sub-BN splits), where the JAX
package's rounding gives sizes that no split count divides."""

import glob
import importlib
import os

import pytest

from efficient_slowfast_tpu.config.parser import \
    load_config_from as jax_load_config_from
from efficient_slowfast_tpu.utils import checkpoint as jax_checkpoint
from efficient_slowfast_tpu.utils import multigrid as jax_multigrid
from efficient_slowfast_tpu_torch.config import load_cfg
from efficient_slowfast_tpu_torch.engine import train
from efficient_slowfast_tpu_torch.ops.norm import effective_num_splits
from efficient_slowfast_tpu_torch.utils import checkpoint, multigrid

jax_train = importlib.import_module("efficient_slowfast_tpu.engine.train")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAPER = os.path.join(ROOT, "configs", "Kinetics",
                     "SLOWFAST_DUAL_8x8_R50_stepwise_multigrid.yaml")


def _multigrid_yamls():
    out = []
    for path in sorted(glob.glob(os.path.join(ROOT, "configs", "*", "*.yaml"))):
        with open(path) as f:
            if "MULTIGRID" in f.read():
                out.append(os.path.relpath(path, ROOT))
    return out


YAMLS = _multigrid_yamls()


def _epochs(cfg, sched, mg, epochs):
    """Per epoch: (B, T, S, BN type, splits, short-cycle crops,
    checkpoint?, eval?)."""
    out = []
    for e in range(epochs):
        if cfg.MULTIGRID.LONG_CYCLE:
            cfg, _ = mg.update_long_cycle(cfg, e)
        out.append((cfg.TRAIN.BATCH_SIZE, cfg.DATA.NUM_FRAMES,
                    cfg.DATA.TRAIN_CROP_SIZE, cfg.BN.NORM_TYPE,
                    cfg.BN.NUM_SPLITS, tuple(sched.short_cycle_shapes(cfg))))
    return out


def test_the_zoo_has_multigrid_configs():
    assert len(YAMLS) == 14
    assert os.path.relpath(PAPER, ROOT) in YAMLS


@pytest.mark.parametrize("yaml_path", YAMLS)
@pytest.mark.parametrize("batch", [None, 8])
def test_schedule_matches_jax(yaml_path, batch):
    opts = [] if batch is None else ["TRAIN.BATCH_SIZE", batch]
    path = os.path.join(ROOT, yaml_path)
    cfg = load_cfg(path, opts)
    jcfg = jax_load_config_from(path, [str(o) for o in opts])
    mg, jmg = multigrid.MultigridSchedule(), jax_multigrid.MultigridSchedule()
    if jcfg.MULTIGRID.LONG_CYCLE and not jcfg.SOLVER.STEPS:
        # a cosine schedule has no steps to allot the long cycle over (the
        # SSv2 yaml): both packages, and the reference, fail alike
        with pytest.raises(IndexError):
            jmg.init_multigrid(jcfg)
        with pytest.raises(IndexError):
            mg.init_multigrid(cfg)
        return
    cfg, jcfg = mg.init_multigrid(cfg), jmg.init_multigrid(jcfg)
    assert mg.schedule == jmg.schedule
    assert list(cfg.SOLVER.STEPS) == list(jcfg.SOLVER.STEPS)
    assert list(cfg.SOLVER.LRS) == list(jcfg.SOLVER.LRS)
    assert cfg.SOLVER.MAX_EPOCH == jcfg.SOLVER.MAX_EPOCH
    epochs = cfg.SOLVER.MAX_EPOCH
    assert _epochs(cfg, multigrid, mg, epochs) == \
        _epochs(jcfg, jax_multigrid, jmg, epochs)
    for e in range(epochs):
        assert checkpoint.is_checkpoint_epoch(cfg, e, mg.schedule) == \
            jax_checkpoint.is_checkpoint_epoch(jcfg, e, jmg.schedule)
        assert train._is_eval_epoch(cfg, e, mg.schedule) == \
            jax_train._is_eval_epoch(jcfg, e, jmg.schedule)


@pytest.mark.parametrize("yaml_path", YAMLS)
def test_short_cycle_batches_are_integer_multiples_that_the_splits_divide(
        yaml_path):
    cfg = load_cfg(os.path.join(ROOT, yaml_path), ["NUM_GPUS", 1])
    if cfg.MULTIGRID.LONG_CYCLE and not cfg.SOLVER.STEPS:
        cfg.MULTIGRID.LONG_CYCLE = False  # no steps to schedule over
    mg = multigrid.MultigridSchedule()
    cfg = mg.init_multigrid(cfg)
    for e in range(cfg.SOLVER.MAX_EPOCH if cfg.MULTIGRID.LONG_CYCLE else 1):
        if cfg.MULTIGRID.LONG_CYCLE:
            cfg, _ = mg.update_long_cycle(cfg, e)
        b, s = cfg.TRAIN.BATCH_SIZE, cfg.DATA.TRAIN_CROP_SIZE
        sizes = multigrid.short_cycle_batch_sizes(cfg)
        crops = multigrid.short_cycle_shapes(cfg)
        factors = [round((s / (f * cfg.MULTIGRID.DEFAULT_S)) ** 2)
                   for f in cfg.MULTIGRID.SHORT_CYCLE_FACTORS]
        assert sizes == [b * factors[0], b * factors[1], b]
        assert crops[2] == s
        if cfg.BN.NORM_TYPE == "sub_batchnorm":
            assert all(x % effective_num_splits(cfg) == 0 for x in sizes)


def test_paper_recipe_on_one_card_jax_batches_break_sub_bn():
    """The paper's yaml on one card: B 512, T 8, S 158, sub-BN of 64
    splits at epoch 0. JAX's rounding gives a 1019-clip first short-cycle
    batch, which 64 splits do not divide (its SubBatchNorm3d asserts), and
    257 and 129 at 224²; the reference's integer factors give 1024, 256
    and 128."""
    jcfg = jax_load_config_from(PAPER, [])
    jmg = jax_multigrid.MultigridSchedule()
    jcfg = jmg.init_multigrid(jcfg)
    cfg = load_cfg(PAPER)
    mg = multigrid.MultigridSchedule()
    cfg = mg.init_multigrid(cfg)
    expect = {  # base shape: (JAX's batches, the port's)
        (8, 8, 158): ([1019, 512, 512], [1024, 512, 512]),
        (2, 16, 224): ([512, 257, 128], [512, 256, 128]),
        (1, 32, 224): ([256, 129, 64], [256, 128, 64])}
    seen = set()
    for e in range(mg.schedule[-1][-1]):
        jcfg, _ = jmg.update_long_cycle(jcfg, e)
        cfg, _ = mg.update_long_cycle(cfg, e)
        shape = tuple(multigrid.get_current_long_cycle_shape(mg.schedule, e))
        if shape in expect and shape not in seen:
            seen.add(shape)
            theirs, ours = expect[shape]
            assert jax_multigrid.short_cycle_batch_sizes(jcfg) == theirs
            assert multigrid.short_cycle_batch_sizes(cfg) == ours
            if cfg.BN.NORM_TYPE == "sub_batchnorm":
                k = effective_num_splits(cfg)
                assert all(b % k == 0 for b in ours)
                assert any(b % k for b in theirs)
        if e == 0:
            assert (jcfg.TRAIN.BATCH_SIZE, jcfg.DATA.NUM_FRAMES,
                    jcfg.DATA.TRAIN_CROP_SIZE, jcfg.BN.NORM_TYPE,
                    jcfg.BN.NUM_SPLITS) == (512, 8, 158, "sub_batchnorm", 64)
            assert effective_num_splits(cfg) == 64
    assert seen == set(expect)


def test_pinned_ring_serves_the_short_cycle_from_its_slots(monkeypatch):
    """The short cycle's batches (here 8, 4, 2 clips) take the leading rows
    of the ring's slots, each sized for the largest: the same page-locked
    buffers every step, none allocated after the ring, and the plain
    loader's bytes. (Page-locking is left out: there is no card here.)"""
    import numpy as np
    import torch

    from efficient_slowfast_tpu_torch.config import get_cfg
    from efficient_slowfast_tpu_torch.data import loader

    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k:
                        empty(*a, **k))
    cfg = get_cfg()
    cfg.MODEL.ARCH, cfg.MODEL.NUM_CLASSES, cfg.SLOWFAST.ALPHA = "slowfast", 5, 2
    cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_JITTER_SCALES = 4, [16, 16]
    cfg.DATA.TRAIN_CROP_SIZE = cfg.MULTIGRID.DEFAULT_S = 16
    cfg.TRAIN.DATASET, cfg.TRAIN.BATCH_SIZE = "synthetic", 2
    cfg.MULTIGRID.SHORT_CYCLE = True
    cfg.DATA_LOADER.NUM_WORKERS = 2
    ld = loader.construct_loader(cfg, "train")
    assert ld.batch_size_schedule == [8, 4, 2]
    ring = loader.PinnedRing(
        (ld.max_batch_size,) + ld.dataset.frames_shape(), ld.prefetch + 2)
    slots = [buf.data_ptr() for buf in ring._host]
    plain = list(ld)
    got = []
    for batch in ld.batches(ring.acquire):
        slot = batch.pop("_slot")
        rows = ring.tensor(slot)
        assert rows.data_ptr() == slots[slot]
        assert rows.shape[0] == len(batch["label"])
        assert np.shares_memory(batch["frames"], rows.numpy())
        batch["frames"] = batch["frames"].copy()  # the slot is refilled
        got.append(batch)
        ring.release(slot, None)
    assert [len(b["label"]) for b in got] == [8, 4, 2] * 4 + [8]  # 64 clips
    assert len(got) == len(plain) == len(ld)
    for a, b in zip(got, plain):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
