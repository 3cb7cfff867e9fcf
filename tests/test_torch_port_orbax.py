"""The port's checkpoints of ``TPU.CHECKPOINT_BACKEND orbax``, f32 on the
CPU: the JAX package's ``.orbax`` directories, written by its own
``save_checkpoint``, read into the port's model through ``tensorstore``
(the weights equal JAX's params through the weight bridge exactly, for
SlowFast and an efficient family, and the epoch); the port's own ``.dcp``
directories (``torch.distributed.checkpoint.async_save``) bit for bit the
``.pyth`` path's state, directly and by auto-resume; and a process that
reads an orbax directory imports neither orbax nor JAX."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.engine.state import TrainState
from efficient_slowfast_tpu.models.optimizer import \
    construct_optimizer as jax_construct_optimizer
from efficient_slowfast_tpu.utils import checkpoint as jax_checkpoint
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                       make_train_step)
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.utils import checkpoint as cu
from efficient_slowfast_tpu_torch.utils.weights import \
    jax_variables_to_state_dict
from torch_port_helpers import (efficient_cfg, efficient_variables,
                                inputs_np, seeded_variables, small_cfg)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH = 2


def write_jax_orbax(jcfg, variables, out_dir, epoch=EPOCH,
                    opt_state=True) -> str:
    """JAX's ``save_checkpoint`` of ``variables`` (with a fresh optax state,
    or none) under ``TPU.CHECKPOINT_BACKEND orbax`` into ``out_dir``;
    returns the ``.orbax`` directory once written."""
    jcfg = jcfg.clone()
    jcfg.TPU.CHECKPOINT_BACKEND = "orbax"
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx, _ = jax_construct_optimizer(jcfg, params)
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(params) if opt_state else None)
    path = jax_checkpoint.save_checkpoint(str(out_dir), state, epoch, jcfg)
    jax_checkpoint.wait_for_saves()
    return path


def _slowfast(get):
    cfg = small_cfg(get, depth=18, trans="basic_transform")
    cfg.DATA.CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    return cfg


CASES = {"slowfast": _slowfast,
         "shufflenet": lambda get: efficient_cfg("shufflenet", get)}


@pytest.fixture(scope="module")
def slowfast_orbax(tmp_path_factory):
    """JAX's orbax directory of the seeded SlowFast, with its optax
    state: (the run directory, the checkpoint, the variables)."""
    d = tmp_path_factory.mktemp("jax_run")
    variables = seeded_variables(_slowfast(get_cfg))
    return d, write_jax_orbax(_slowfast(jax_get_cfg), variables, d), variables


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_orbax_directory_loads_into_the_port_exactly(name, tmp_path,
                                                         slowfast_orbax):
    """The model's state dict equals the bridge's of JAX's variables; an
    efficient family (its directory written without an optimizer state,
    to keep the test short) maps through its name table."""
    cfg = CASES[name](get_cfg)
    if name == "slowfast":
        tmp_path, path, variables = slowfast_orbax
    else:
        variables = efficient_variables(cfg)
        path = write_jax_orbax(CASES[name](jax_get_cfg), variables, tmp_path,
                               opt_state=False)
    assert path.endswith(".orbax") and os.path.isfile(
        os.path.join(path, "_METADATA"))
    want = jax_variables_to_state_dict(variables, cfg)
    model = build_model(cfg, device="cpu")
    epoch = cu.load_checkpoint(path, model, None, cfg)
    assert epoch == EPOCH
    got = model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], torch.as_tensor(np.asarray(v))), k
    # by TRAIN.CHECKPOINT_FILE_PATH and auto-resume from OUTPUT_DIR: the
    # same weights; the optimizer keeps its fresh state (with a warning)
    for auto in (False, True):
        run = cfg.clone()
        run.OUTPUT_DIR = str(tmp_path) if auto else str(tmp_path / "new")
        run.TRAIN.AUTO_RESUME = auto
        run.TRAIN.CHECKPOINT_FILE_PATH = "" if auto else path
        state = create_train_state(run, build_model(run, device="cpu"),
                                   device="cpu")
        state, start = cu.load_train_checkpoint(run, state)
        assert start == (EPOCH + 1 if auto else 0)
        sd = state.model.state_dict()
        assert all(torch.equal(sd[k], got[k]) for k in got)
        assert not state.optimizer.state


def test_orbax_directory_without_metadata_names_it(tmp_path):
    empty = tmp_path / "checkpoint_epoch_00001.orbax"
    empty.mkdir()
    model = build_model(_slowfast(get_cfg), device="cpu")
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        cu.load_checkpoint(str(empty), model)


def _trained_state(cfg):
    """The port's train state of ``cfg`` after two steps (moments set)."""
    torch.manual_seed(0)
    state = create_train_state(cfg, build_model(cfg, device="cpu"),
                               device="cpu")
    step = make_train_step(cfg, state.model, state.optimizer)
    for i in range(2):
        x = [torch.from_numpy(a) for a in inputs_np(cfg, 2, 30 + i)]
        step(state, x, torch.tensor([1, 3]), 0.01, torch.Generator())
    return state


def _same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            w = ob["state"][i][k]
            assert v.dtype == w.dtype and torch.equal(v, w), (i, k)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_dcp_round_trip_and_resume_equal_the_pyth_path(moments, tmp_path):
    cfg = _slowfast(get_cfg)
    cfg.TPU.OPTIMIZER_STATE_DTYPE = moments
    cfg.MODEL.DROPOUT_RATE = 0.0
    state = _trained_state(cfg)
    pyth = cu.save_checkpoint(str(tmp_path / "pyth"), state, 0, cfg)
    cfg.TPU.CHECKPOINT_BACKEND = "orbax"
    cfg.OUTPUT_DIR = str(tmp_path / "dcp")
    dcp_path = cu.save_checkpoint(cfg.OUTPUT_DIR, state, 0, cfg)
    cu.wait_for_saves()
    d = os.path.dirname(dcp_path)
    assert sorted(os.listdir(d)) == ["cfg_epoch_00001.yaml",
                                     "checkpoint_epoch_00001.dcp"]
    assert cu.get_last_checkpoint(cfg.OUTPUT_DIR) == dcp_path
    loaded = {}
    for name, path in (("pyth", pyth), ("dcp", dcp_path)):
        fresh = create_train_state(cfg, build_model(cfg, device="cpu"),
                                   device="cpu")
        assert cu.load_checkpoint(path, fresh.model, fresh.optimizer,
                                  cfg) == 0
        loaded[name] = fresh
    _same_state(loaded["dcp"], loaded["pyth"])
    # auto-resume from the run directory
    cfg.TRAIN.AUTO_RESUME = True
    fresh = create_train_state(cfg, build_model(cfg, device="cpu"),
                               device="cpu")
    fresh, start = cu.load_train_checkpoint(cfg, fresh)
    assert start == 1
    _same_state(fresh, loaded["pyth"])
    # the saved state is the live one's (BN statistics in the plain form)
    _same_state(loaded["dcp"], state)


_NO_ORBAX = """
import sys
import torch
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.utils import checkpoint as cu
model = build_model(torch.load({cfg!r}, weights_only=False), device="cpu")
assert cu.load_checkpoint({path!r}, model, None, None) == {epoch}
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("orbax", "jax", "jaxlib", "flax", "efficient_slowfast_tpu"))
print("IMPORTED", bad)
assert not bad, bad
"""


def test_reading_orbax_imports_neither_orbax_nor_jax(tmp_path,
                                                    slowfast_orbax):
    torch.save(_slowfast(get_cfg), tmp_path / "cfg.pt")
    code = _NO_ORBAX.format(cfg=str(tmp_path / "cfg.pt"),
                            path=slowfast_orbax[1], epoch=EPOCH)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "IMPORTED []" in out.stdout
