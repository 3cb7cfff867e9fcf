"""Every module of the PyTorch port imports, and a train step runs, while
jax, flax, optax and the JAX package are blocked."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TRAIN_STEP = r"""
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "efficient_slowfast_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import torch
import efficient_slowfast_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(
    port.__path__, "efficient_slowfast_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"efficient_slowfast_tpu_torch.engine.state",
        "efficient_slowfast_tpu_torch.models.losses",
        "efficient_slowfast_tpu_torch.models.optimizer",
        "efficient_slowfast_tpu_torch.utils.metrics"} <= set(names), names
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.engine.state import (
    create_train_state, make_train_step, pathway_inputs)
from efficient_slowfast_tpu_torch.models import build_model
cfg = get_cfg()
cfg.RESNET.WIDTH_PER_GROUP = 8
cfg.RESNET.DEPTH = 18
cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[2, 2], [2, 2], [2, 2], [2, 2]]
cfg.RESNET.SPATIAL_STRIDES = [[1, 1], [2, 2], [2, 2], [2, 2]]
cfg.RESNET.SPATIAL_DILATIONS = [[1, 1]] * 4
cfg.NONLOCAL.LOCATION = [[[], []]] * 4
cfg.SLOWFAST.ALPHA = 4
cfg.DATA.NUM_FRAMES = 4
cfg.DATA.CROP_SIZE = 32
cfg.MODEL.NUM_CLASSES = 5
cfg.TPU.COMPUTE_DTYPE = "float32"
cfg.TPU.REMAT = True
torch.set_num_threads(1)
state = create_train_state(cfg, build_model(cfg, device="cpu"), device="cpu")
step = make_train_step(cfg, state.model, state.optimizer)
x = [t.uniform_(generator=torch.Generator().manual_seed(0))
     for t in pathway_inputs(cfg, 2, device="cpu")]
mets = step(state, x, torch.tensor([1, 3]), 0.01,
            torch.Generator().manual_seed(0))
assert state.step == 1 and torch.isfinite(mets["loss"]), mets
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "flax", "optax", "efficient_slowfast_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("OK")
"""


def test_every_port_module_imports_and_trains_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_STEP], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")
