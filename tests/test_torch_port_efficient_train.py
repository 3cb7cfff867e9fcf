"""One composed train step of SlowFastShuffleNetV2 (w2.0) and
SlowFastGhostNet (w1.0) in the port (``create_train_state``,
``make_train_step``) against the JAX package's ``make_train_step`` on the
same weights (attention calibrated to logit std 3) and batch, f32 on the
CPU, as the zoo yamls train: SGD lr 0.01 with nesterov momentum 0.9,
weight decay 1e-4 and none on BN, no dropout; 8 frames, crop 32, 2 clips,
TPU.FLASH_MIN_TOKENS 16 (the streaming attention and its backward).

What float32 repeats, and how it is held:
- The loss: rtol 1e-3, the train-mode tolerance of
  tests/test_full_model_parity.py (measured 7.3e-5 on ShuffleNetV2, whose
  s4 BN normalises 4 values a channel at this crop, and 3.6e-6 on
  GhostNet).
- The BN running statistics the step's forward updates: rtol 1e-3, atol
  2e-3, the same tolerances.
- The weight decay each parameter took: from the port's step Δ and its
  gradient g, −Δ / (lr (1 + μ)) − g is the decay times the parameter p;
  its least-squares coefficient on p, per parameter tensor, is held to
  JAX's (``bn_mask``: 0 for BN, 1e-4 else) within 5e-5 (half the decay;
  measured within 2.1e-5, on a query bias whose gradient is large beside
  its values). A BN parameter decayed as the others are is 1e-4 off: this
  is where the name rule that the port had fails (both steps, checked).
- The whole step, all parameters in L2: within 0.15 of JAX's (measured
  2.2% and 3.0%). These models are ill-conditioned in float32 at init:
  rounding differences of 1e-7 in the forward (the streaming against the
  dense attention, say) move single gradients by several percent through
  max-pool ties and train-mode BN's scale invariance (a BN scale before a
  depthwise conv and BN has a zero gradient in exact arithmetic); on other
  inputs the port's step was 7.0% from JAX's on GhostNet, and 0.13% with
  the dense attention on both sides. A wrong lr, momentum or decay moves
  it by the step itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.engine.state import TrainState as JaxTrainState
from efficient_slowfast_tpu.engine.state import \
    make_train_step as jax_make_train_step
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu.models.optimizer import bn_mask
from efficient_slowfast_tpu.models.optimizer import \
    construct_optimizer as jax_construct_optimizer
from efficient_slowfast_tpu.ops.options import configure
from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                       make_train_step)
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.utils.weights import (
    jax_variables_to_state_dict, state_dict_to_jax_variables)
from torch_port_helpers import (calibrate_fusions, compiled, efficient_cfg,
                                efficient_variables, flat_leaves, inputs_np,
                                torch_inputs)

LR = 0.01
STATS_TOL = dict(rtol=1e-3, atol=2e-3)
STEP_TOL = 0.15
DECAY_TOL = 5e-5


@pytest.fixture(autouse=True)
def _restore_jax_options():
    yield
    configure(jax_get_cfg())  # JAX keeps its kernel options process-wide


def _jax_step(family, variables, inputs, labels):
    jcfg = efficient_cfg(family, jax_get_cfg, train=True)
    configure(jcfg)
    model = jax_build_model(jcfg)
    tx, _ = jax_construct_optimizer(jcfg, variables["params"])
    step = jax_make_train_step(jcfg, model, tx)
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params=tree(variables["params"]),
                          batch_stats=tree(variables["batch_stats"]),
                          opt_state=tx.init(variables["params"]))
    state, mets = compiled(step, state, [jnp.asarray(x) for x in inputs],
                           jnp.asarray(labels), LR, jax.random.PRNGKey(0))
    after = jax.tree_util.tree_map(
        lambda a: np.array(a, copy=True),
        {"params": state.params, "batch_stats": state.batch_stats})
    decay = jax.tree_util.tree_map(
        lambda bn: jcfg.BN.WEIGHT_DECAY if bn else jcfg.SOLVER.WEIGHT_DECAY,
        bn_mask(variables["params"], True))
    return float(mets["loss"]), flat_leaves(after), flat_leaves(
        {"params": decay})


@pytest.mark.parametrize("family", ["shufflenetv2", "ghostnet"])
def test_train_step_matches_jax(family):
    cfg = efficient_cfg(family, train=True)
    inputs = inputs_np(cfg, seed=10)
    labels = np.random.RandomState(110).randint(0, cfg.MODEL.NUM_CLASSES, 2)
    variables = calibrate_fusions(cfg, efficient_variables(cfg), inputs)
    before = flat_leaves(variables)
    jax_loss, jax_after, decay = _jax_step(family, variables, inputs, labels)

    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg),
                          strict=True)
    state = create_train_state(cfg, model, device="cpu")
    step = make_train_step(cfg, state.model, state.optimizer)
    mets = step(state, torch_inputs(inputs), torch.from_numpy(labels), LR)
    sd = state.model.state_dict()
    after = flat_leaves(state_dict_to_jax_variables(sd, cfg))
    grads = flat_leaves(state_dict_to_jax_variables(
        {**sd, **{n: p.grad for n, p in state.model.named_parameters()}},
        cfg))

    np.testing.assert_allclose(float(mets["loss"]), jax_loss,
                               rtol=STATS_TOL["rtol"])
    assert after.keys() == jax_after.keys()
    params = [k for k in after if k.startswith("params/")]
    for key in after:
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(after[key], jax_after[key],
                                       err_msg=key, **STATS_TOL)
    momentum, decays = cfg.SOLVER.MOMENTUM, {}
    for key in params:
        p = before[key].astype(np.float64)
        if not np.any(p):  # a zero parameter shows no decay (BN biases)
            continue
        taken = -(after[key] - p) / (LR * (1 + momentum)) - grads[key]
        decays[key] = float(np.sum(taken * p) / np.sum(p * p))
    worst = max(decays, key=lambda k: abs(decays[k] - decay[k]))
    assert abs(decays[worst] - decay[worst]) <= DECAY_TOL, (
        worst, decays[worst], decay[worst])
    dist = lambda a, b: sum(  # noqa: E731
        float(np.sum((a[k].astype(np.float64) - b[k]) ** 2))
        for k in params) ** 0.5
    assert dist(after, jax_after) <= STEP_TOL * dist(jax_after, before), (
        dist(after, jax_after) / dist(jax_after, before))
