"""Checkpoints of the port against the JAX package's, f32 on the CPU, CMDA-R50
at width 16 (attention calibrated as tests/test_torch_port_train.py does
it): a port ``.pyth`` taken in a split-BN phase, read by JAX's
``load_torch_checkpoint``, gives JAX's eval forward the port's logits; a
``.jaxckpt`` written by JAX's ``save_checkpoint``, read by the port as type
``jax``, gives the port JAX's; both at 1e-4 (rtol = atol, the precedent of
tests/test_full_model_parity.py). Also: bfloat16 optimizer moments and
every tensor round-trip bit for bit, and ``train()`` for 2 epochs equals 1
epoch, an auto-resume and 1 more epoch, bit for bit."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.engine.state import TrainState as JaxTrainState
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu.models.optimizer import \
    construct_optimizer as jax_construct_optimizer
from efficient_slowfast_tpu.ops.options import configure
from efficient_slowfast_tpu.utils import checkpoint as jax_checkpoint
from efficient_slowfast_tpu.utils.torch_ckpt import load_torch_checkpoint
from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                       make_train_step)
from efficient_slowfast_tpu_torch.engine.train import train
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.ops.norm import aggregate_sub_bn_stats
from efficient_slowfast_tpu_torch.utils import checkpoint
from efficient_slowfast_tpu_torch.utils.weights import \
    jax_variables_to_state_dict
from torch_port_helpers import (calibrate_attention, inputs_np,
                                seeded_variables, small_cfg, torch_inputs)

TOL = dict(rtol=1e-4, atol=1e-4)
CMDA = dict(model="SlowFastDualAttention")


@pytest.fixture(autouse=True)
def _restore_jax_options():
    yield
    configure(jax_get_cfg())  # JAX keeps its kernel options process-wide


@pytest.fixture(scope="module")
def cmda():
    """(JAX-layout variables with jittered, calibrated statistics, the JAX
    eval forward, seeded inputs)."""
    inputs = inputs_np(small_cfg(**CMDA), batch=2, seed=5)
    variables = calibrate_attention(seeded_variables(small_cfg(**CMDA)),
                                    inputs, **CMDA)
    model = jax_build_model(small_cfg(jax_get_cfg, **CMDA))
    fwd = jax.jit(functools.partial(model.apply, train=False))
    yield variables, fwd, inputs
    configure(jax_get_cfg())


def _port_logits(model, inputs):
    with torch.no_grad():
        return model.eval()(torch_inputs(inputs)).numpy()


def _jax_logits(fwd, variables, inputs):
    return np.asarray(fwd(variables, [jnp.asarray(x) for x in inputs]))


def test_split_bn_pyth_gives_jax_the_ports_logits(cmda, tmp_path):
    variables, fwd, inputs = cmda
    cfg = small_cfg(**CMDA)
    cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS = "sub_batchnorm", 2
    model = build_model(cfg, device="cpu")
    sd = jax_variables_to_state_dict(variables)
    # split statistics drawn around the plain ones, then aggregated
    rs = np.random.RandomState(7)
    target = dict(model.state_dict())
    for k, v in target.items():
        if k.endswith(("split_bn.running_mean", "split_bn.running_var")):
            base = sd[k.replace("split_bn.", "")].repeat(2)
            jitter = rs.uniform(0.8, 1.2, v.shape).astype(np.float32)
            target[k] = base * torch.from_numpy(jitter)
        elif k in sd:
            target[k] = sd[k]
    model.load_state_dict(target, strict=True)
    aggregate_sub_bn_stats(model)
    state = create_train_state(cfg, model, device="cpu")
    path = checkpoint.save_checkpoint(str(tmp_path), state, 0, cfg)
    assert os.path.basename(path) == "checkpoint_epoch_00001.pyth"
    ours = _port_logits(model, inputs)

    payload = torch.load(path, weights_only=True)
    assert sorted(payload) == ["cfg", "epoch", "model_state",
                               "optimizer_state"]
    assert not any("split_bn" in k for k in payload["model_state"])
    params, stats = load_torch_checkpoint(
        small_cfg(jax_get_cfg, **CMDA), path, variables["params"],
        variables["batch_stats"])
    theirs = _jax_logits(fwd, {"params": params, "batch_stats": stats},
                         inputs)
    np.testing.assert_allclose(theirs, ours, **TOL)
    # the port's plain-BN build reads it with strict=True too
    plain = build_model(small_cfg(**CMDA), device="cpu")
    checkpoint._load_external(plain, path, "pytorch")
    np.testing.assert_allclose(_port_logits(plain, inputs), ours, **TOL)


def test_jaxckpt_gives_the_port_jax_logits(cmda, tmp_path):
    variables, fwd, inputs = cmda
    jcfg = small_cfg(jax_get_cfg, **CMDA)
    tx, _ = jax_construct_optimizer(jcfg, variables["params"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    path = jax_checkpoint.save_checkpoint(str(tmp_path), state, 2, jcfg)
    theirs = _jax_logits(fwd, variables, inputs)

    cfg = small_cfg(**CMDA)
    cfg.TEST.CHECKPOINT_FILE_PATH, cfg.TEST.CHECKPOINT_TYPE = path, "jax"
    model = build_model(cfg, device="cpu")
    checkpoint.load_test_checkpoint(cfg, model)
    np.testing.assert_allclose(_port_logits(model, inputs), theirs, **TOL)
    # as a run's own checkpoint too (a JAX run's OUTPUT_DIR), in split form
    cfg.TEST.CHECKPOINT_FILE_PATH = ""
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS = "sub_batchnorm", 4
    model = build_model(cfg, device="cpu")
    assert checkpoint.get_last_checkpoint(str(tmp_path)) == path
    assert checkpoint.load_checkpoint(path, model) == 2
    np.testing.assert_allclose(_port_logits(model, inputs), theirs, **TOL)


def _assert_tree_identical(a, b, where=""):
    if torch.is_tensor(b):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(b, dict):
        assert set(a) == set(b), where
        for k in b:
            _assert_tree_identical(a[k], b[k], f"{where}/{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_identical(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def test_bf16_moments_and_every_tensor_round_trip_bit_for_bit(tmp_path):
    cfg = small_cfg()
    cfg.TPU.OPTIMIZER_STATE_DTYPE = "bfloat16"
    cfg.SOLVER.MOMENTUM, cfg.SOLVER.NESTEROV = 0.9, True
    cfg.MODEL.DROPOUT_RATE = 0.0
    torch.manual_seed(0)
    state = create_train_state(cfg, build_model(cfg, device="cpu"), "cpu")
    step = make_train_step(cfg, state.model, state.optimizer)
    inputs = torch_inputs(inputs_np(cfg, batch=2, seed=1))
    labels = torch.tensor([1, 3])
    step(state, inputs, labels, 0.1)
    path = checkpoint.save_checkpoint(str(tmp_path), state, 4, cfg)
    saved = checkpoint.checkpoint_payload(state, 4, cfg)

    torch.manual_seed(1)
    fresh = create_train_state(cfg, build_model(cfg, device="cpu"), "cpu")
    assert checkpoint.load_checkpoint(path, fresh.model, fresh.optimizer) == 4
    loaded = checkpoint.checkpoint_payload(fresh, 4, cfg)
    _assert_tree_identical(loaded["model_state"], saved["model_state"])
    _assert_tree_identical(loaded["optimizer_state"],
                           saved["optimizer_state"])
    moments = [s["momentum_buffer"]
               for s in fresh.optimizer.state.values()]
    assert moments and all(m.dtype == torch.bfloat16 for m in moments)
    # and the next step is the same step
    a = step(state, inputs, labels, 0.1)["loss"]
    b = make_train_step(cfg, fresh.model, fresh.optimizer)(
        fresh, inputs, labels, 0.1)["loss"]
    assert torch.equal(a, b)
    _assert_tree_identical(fresh.model.state_dict(), state.model.state_dict())


def _train_cfg(out_dir, max_epoch):
    cfg = small_cfg()
    s = 32
    cfg.DATA.CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = cfg.DATA.TRAIN_CROP_SIZE = s
    cfg.DATA.TRAIN_JITTER_SCALES = [s, 40]
    cfg.TRAIN.DATASET = "synthetic"
    cfg.TRAIN.BATCH_SIZE = 16
    cfg.TRAIN.EVAL_PERIOD = 1
    cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.TRAIN.AUTO_RESUME = True
    cfg.MODEL.DROPOUT_RATE = 0.5
    cfg.BN.USE_PRECISE_STATS = True
    cfg.BN.NUM_BATCHES_PRECISE = 2
    cfg.SOLVER.LR_POLICY = "steps_with_relative_lrs"
    cfg.SOLVER.STEPS, cfg.SOLVER.LRS = [0], [1.0]
    cfg.SOLVER.BASE_LR, cfg.SOLVER.WARMUP_EPOCHS = 0.05, 0.0
    cfg.SOLVER.MOMENTUM = 0.9
    cfg.SOLVER.MAX_EPOCH = max_epoch
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.OUTPUT_DIR = str(out_dir)
    return cfg


def test_train_resumes_bit_for_bit(tmp_path):
    """2 epochs in one run against 1 epoch, then a run that auto-resumes
    from its checkpoint for the second: the same parameters, statistics
    and optimizer state, bit for bit (the lr is constant, so the first
    run's shorter MAX_EPOCH changes nothing else)."""
    whole = train(_train_cfg(tmp_path / "whole", 2), device="cpu")
    train(_train_cfg(tmp_path / "split", 1), device="cpu")
    names = sorted(os.listdir(tmp_path / "split" / "checkpoints"))
    assert names == ["checkpoint_epoch_00001.pyth"]
    resumed = train(_train_cfg(tmp_path / "split", 2), device="cpu")
    assert resumed.step == whole.step // 2  # one epoch of steps
    for a, b in ((resumed, whole),):
        _assert_tree_identical(a.model.state_dict(), b.model.state_dict())
        _assert_tree_identical(
            checkpoint._to_cpu(a.optimizer.state_dict()),
            checkpoint._to_cpu(b.optimizer.state_dict()))
    files = [torch.load(tmp_path / run / "checkpoints" /
                        "checkpoint_epoch_00002.pyth", weights_only=True)
             for run in ("whole", "split")]
    _assert_tree_identical(files[1]["model_state"], files[0]["model_state"])
    assert files[0]["epoch"] == files[1]["epoch"] == 1
