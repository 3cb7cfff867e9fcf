"""The port's train and val epochs against the JAX package's, on the same
weights, the same synthetic loaders (seeded alike) and the same
deterministic preprocess: scale jitter [S, S] with a crop of S, no flip,
the crop's long-axis position given (0.5) on both sides, dropout 0,
lr 0.01. SlowFast R18 (basic blocks) at width 16, 8 frames, a 32² crop,
f32 on the CPU: each step's loss and the parameters after the epoch at
rtol = atol = 1e-4 (the precedent of tests/test_torch_port_train.py for
composed steps), the val meter's errors over a padded tail likewise."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.data.loader import \
    construct_loader as jax_construct_loader
from efficient_slowfast_tpu.data.preprocess import \
    make_train_preprocess as jax_make_train_preprocess
from efficient_slowfast_tpu.engine.state import TrainState as JaxTrainState
from efficient_slowfast_tpu.engine.state import \
    make_eval_step as jax_make_eval_step
from efficient_slowfast_tpu.engine.state import \
    make_train_step as jax_make_train_step
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu.models.optimizer import \
    construct_optimizer as jax_construct_optimizer
from efficient_slowfast_tpu.ops.options import configure
from efficient_slowfast_tpu.parallel.mesh import build_mesh
from efficient_slowfast_tpu.utils import meters as jax_meters
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.data.loader import construct_loader
from efficient_slowfast_tpu_torch.data.preprocess import make_train_preprocess
from efficient_slowfast_tpu_torch.engine import train
from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                       make_eval_step,
                                                       make_train_step)
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.utils import lr_policy, meters
from efficient_slowfast_tpu_torch.utils.weights import (
    jax_variables_to_state_dict, state_dict_to_jax_variables)
from torch_port_helpers import flat_leaves, seeded_variables, train_cfg

# the JAX package's engine/__init__ shadows the module with its train()
jax_train = importlib.import_module("efficient_slowfast_tpu.engine.train")
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = dict(model="SlowFast", depth=18, trans="basic_transform")
TRAIN_CLIPS, VAL_CLIPS, BATCH = 6, 5, 2  # 3 steps; val 2 + 2 + 1 padded
CROP_U = 0.5


def loop_cfg(get):
    cfg = train_cfg(get, **ARCH)
    s = 32
    cfg.DATA.CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = s
    cfg.DATA.TRAIN_CROP_SIZE = s
    cfg.DATA.TRAIN_JITTER_SCALES = [s, s]
    cfg.DATA.RANDOM_FLIP = False
    cfg.TRAIN.DATASET = "synthetic"
    cfg.TRAIN.BATCH_SIZE = BATCH
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.MAX_EPOCH = 10
    cfg.TPU.METRICS_PERIOD = 2  # read back after step 2, then at the end
    cfg.LOG_PERIOD = 1
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.TPU.DATA_AXIS = 1  # one device, one batch divisor: the port's
    return cfg


def loaders(cfg, construct):
    """The train and val loaders over the first clips of the synthetic
    splits (TRAIN_CLIPS and VAL_CLIPS)."""
    out = []
    for split, n in (("train", TRAIN_CLIPS), ("val", VAL_CLIPS)):
        ld = construct(cfg, split)
        ds = ld.dataset
        for name in ("_path_to_videos", "_labels", "_spatial_temporal_idx"):
            setattr(ds, name, getattr(ds, name)[:n])
        out.append(ld)
    return out


def recording(step, lrs, losses, jax_state=False):
    def run(*args):
        lrs.append(args[3])
        out = step(*args)
        losses.append(out[1]["loss"] if jax_state else out["loss"])
        return out
    return run


@pytest.fixture(scope="module")
def epochs():
    cfg = loop_cfg(jax_get_cfg)
    model = jax_build_model(cfg)
    variables = seeded_variables(loop_cfg(get_cfg))

    # JAX
    tx, _ = jax_construct_optimizer(cfg, variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(variables["params"]))
    pre = jax_make_train_preprocess(cfg)
    fixed = lambda k, f, w, p, u: pre(k, f, w, p,  # noqa: E731
                                      jnp.full(u.shape, CROP_U, jnp.float32))
    train_loader, val_loader = loaders(cfg, jax_construct_loader)
    train_loader.set_epoch(0)
    mesh, rng = build_mesh(cfg), jax.random.PRNGKey(0)
    jax_lrs, jax_losses = [], []
    state = jax_train.train_epoch(
        cfg, state,
        recording(jax_make_train_step(cfg, model, tx), jax_lrs, jax_losses,
                  jax_state=True),
        fixed, train_loader, jax_meters.TrainMeter(len(train_loader), cfg), 0,
        mesh, rng)
    jax_val = jax_meters.ValMeter(len(val_loader), cfg)
    jax_top1 = jax_train.eval_epoch(cfg, state, jax_make_eval_step(cfg, model),
                                    fixed, val_loader, jax_val, 0, mesh, rng)
    jax_after = jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    configure(jax_get_cfg())  # JAX keeps its kernel options process-wide

    # the port
    cfg = loop_cfg(get_cfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    tstate = create_train_state(cfg, model, device="cpu")
    pre = make_train_preprocess(cfg)
    fixed = lambda g, f, w, p, u: pre(g, f, w, p,  # noqa: E731
                                      torch.full(u.shape, CROP_U))
    train_loader, val_loader = loaders(cfg, construct_loader)
    train_loader.set_epoch(0)
    lrs, losses = [], []
    train.train_epoch(cfg, tstate,
                      recording(make_train_step(cfg, model, tstate.optimizer),
                                lrs, losses),
                      fixed, train_loader,
                      meters.TrainMeter(len(train_loader), cfg), 0)
    val = meters.ValMeter(len(val_loader), cfg)
    top1 = train.eval_epoch(cfg, tstate, make_eval_step(cfg, model), fixed,
                            val_loader, val, 0)
    after = state_dict_to_jax_variables(tstate.model.state_dict())
    return dict(cfg=cfg, jax=(jax_lrs, jax_losses, jax_after, jax_top1,
                              jax_val), port=(lrs, losses, after, top1, val),
                state=tstate)


def test_train_epoch_matches_jax(epochs):
    jax_lrs, jax_losses, jax_after, _, _ = epochs["jax"]
    lrs, losses, after, _, _ = epochs["port"]
    assert len(losses) == len(jax_losses) == TRAIN_CLIPS // BATCH
    assert epochs["state"].step == len(losses)
    np.testing.assert_allclose([float(x) for x in losses],
                               [float(x) for x in jax_losses], **TOL)
    cfg = epochs["cfg"]
    expect = [lr_policy.get_lr_at_epoch(cfg, i / len(losses))
              for i in range(len(losses))]
    assert lrs == jax_lrs == expect
    fp, fr = flat_leaves(after), flat_leaves(jax_after)
    assert set(fp) == set(fr)
    for key in sorted(fr):
        np.testing.assert_allclose(fp[key], fr[key], err_msg=key, **TOL)


def test_eval_epoch_matches_jax_over_a_padded_tail(epochs):
    _, _, _, jax_top1, jax_val = epochs["jax"]
    _, _, _, top1, val = epochs["port"]
    assert top1 == pytest.approx(jax_top1, abs=1e-4)
    assert val.min_top_k_err == pytest.approx(jax_val.min_top_k_err, abs=1e-4)
    assert 0 <= top1 <= 100


def test_nan_loss_and_short_cycle_raise():
    with pytest.raises(RuntimeError, match="NaN"):
        train.check_nan_losses(float("nan"))
    # a short-cycle epoch over batches that carry no phase has no crop to
    # take: the loader was not construct_loader's
    cfg = loop_cfg(get_cfg)
    cfg.MULTIGRID.SHORT_CYCLE = True
    model = torch.nn.Linear(1, 1)
    state = create_train_state(cfg, model, device="cpu")
    ld = loader_without_phase(cfg)
    with pytest.raises(ValueError, match="_phase"):
        train.train_epoch(cfg, state, None, lambda *a: None, ld,
                          meters.TrainMeter(len(ld), cfg), 0)


def loader_without_phase(cfg):
    plain = cfg.clone()
    plain.MULTIGRID.SHORT_CYCLE = False
    ld, _ = loaders(plain, construct_loader)
    return ld


def test_step_generators_are_seeded_by_seed_and_counter():
    draw = lambda s, c: torch.rand(  # noqa: E731
        3, generator=train.step_generator(s, c, "cpu")).tolist()
    assert draw(0, 5) == draw(0, 5)
    assert len({tuple(draw(s, c)) for s in (0, 1) for c in (0, 1, 2)}) == 6


@pytest.mark.parametrize("epoch,expect", [(0, False), (9, True), (19, True),
                                          (195, True), (10, False)])
def test_is_eval_epoch_matches_jax(epoch, expect):
    cfgs = [get_cfg(), jax_get_cfg()]
    for cfg in cfgs:
        cfg.SOLVER.MAX_EPOCH = 196
        cfg.TRAIN.EVAL_PERIOD = 10
    assert train._is_eval_epoch(cfgs[0], epoch) == expect
    assert jax_train._is_eval_epoch(cfgs[1], epoch) == expect
    schedule = [[0, 0, 0, 4], [0, 0, 0, 12]]
    assert train._is_eval_epoch(cfgs[0], epoch, schedule) == \
        jax_train._is_eval_epoch(cfgs[1], epoch, schedule)
