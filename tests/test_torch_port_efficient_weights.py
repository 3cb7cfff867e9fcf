"""The efficient families' weights between the port, the JAX package and the
reference's layout, on the CPU (no JAX compile: the JAX trees come from the
port's seeded init through the weight bridge, or from
``jax.eval_shape(model.init, …)``).

- The bridge with the families' name table
  (``utils/weights.py::efficient_prefix_table``) gives, key for key and
  value for value, the dict of the JAX package's
  ``utils/torch_ckpt.py::export_torch_state_dict``; the port's model loads
  it with ``strict=True`` and gives the same variables back.
- The state_dicts of ``tests/torch_golden.py``'s reference-layout models
  load into the port's with ``strict=True`` (every golden name is the
  table's), and both give the same eval scores.
- Every efficient yaml under ``configs/`` builds in the port, with the
  names and shapes of JAX's export of its ``eval_shape`` init.
- ``BN.NORM_TYPE sub_batchnorm`` on ShuffleNetV2: the split BNs under the
  Sequential-index names convert both ways and map to JAX's tree.
- Checkpoints: a ``.jaxckpt`` written by the JAX package loads into the
  port's model through ``load_test_checkpoint``, and a ``.pyth`` written by
  the port loads into JAX's variables through ``load_torch_checkpoint``,
  both exactly."""

import functools
import glob
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
from efficient_slowfast_tpu.utils import checkpoint as jax_checkpoint
from efficient_slowfast_tpu.utils.torch_ckpt import (export_torch_state_dict,
                                                     load_torch_checkpoint)
from efficient_slowfast_tpu_torch.config import load_cfg
from efficient_slowfast_tpu_torch.engine.state import create_train_state
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.ops.norm import (SubBatchNorm3d,
                                                   normal_to_sub_bn,
                                                   sub_to_normal_bn)
from efficient_slowfast_tpu_torch.utils import checkpoint
from efficient_slowfast_tpu_torch.utils.weights import (
    jax_variables_to_state_dict, state_dict_to_jax_variables)
from torch_port_helpers import (EFFICIENT, efficient_cfg,
                                efficient_variables, flat_leaves, inputs_np,
                                torch_inputs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FAMILIES = ("SlowFastShuffleNetV2", "SlowFastShuffleNet",
             "SlowFastMoibleNetV2", "SlowFastGhostNet")
YAMLS = sorted(
    os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True)
    if any(f"MODEL_NAME: {f}" in open(p).read() for f in _FAMILIES))


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("family", sorted(EFFICIENT))
def test_bridge_is_jax_export_and_round_trips(family):
    cfg = efficient_cfg(family)
    variables = efficient_variables(cfg)
    sd = jax_variables_to_state_dict(variables, cfg)
    want = export_torch_state_dict(variables["params"],
                                   variables["batch_stats"],
                                   efficient_cfg(family, jax_get_cfg))
    got = _numpy(sd)
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    back = state_dict_to_jax_variables(model.state_dict(), cfg)
    assert flat_leaves(back).keys() == flat_leaves(variables).keys()
    for key, value in flat_leaves(variables).items():
        np.testing.assert_array_equal(flat_leaves(back)[key], value,
                                      err_msg=key)


def _golden(family):
    import torch_golden as tg

    name, wm, groups, _ = EFFICIENT[family]
    kw = dict(num_classes=12, alpha=4, beta_inv=8)
    return {"SlowFastShuffleNetV2": lambda: tg.TorchShuffleNetV2(
                width_mult=wm, **kw),
            "SlowFastShuffleNet": lambda: tg.TorchShuffleNet(
                width_mult=wm, groups=groups, **kw),
            "SlowFastMoibleNetV2": lambda: tg.TorchMobileNetV2(
                width_mult=wm, **kw),
            "SlowFastGhostNet": lambda: tg.TorchGhostNet(
                width_mult=wm, **kw)}[name]()


@pytest.mark.parametrize("family", sorted(EFFICIENT))
def test_reference_layout_loads_strict(family):
    """The golden model's state_dict (the reference's names) loads into the
    port's model with strict=True, and the two give the same eval scores
    (every attention γ 0.5, BN statistics jittered)."""
    torch.manual_seed(0)
    golden = _golden(family)
    with torch.no_grad():
        for name, t in golden.state_dict().items():
            if name.endswith("gamma"):
                t.fill_(0.5)
            elif name.endswith("running_mean"):
                t.normal_(0.0, 0.05)
            elif name.endswith("running_var"):
                t.uniform_(0.8, 1.2)
    cfg = efficient_cfg(family, flash_min_tokens=1024)
    model = build_model(cfg, device="cpu")
    ours = {k for k in model.state_dict()}
    theirs = {k for k in golden.state_dict()}
    assert ours == theirs, (sorted(ours - theirs)[:5],
                            sorted(theirs - ours)[:5])
    model.load_state_dict(golden.state_dict(), strict=True)
    inputs = torch_inputs(inputs_np(cfg))
    with torch.no_grad():
        want = golden.eval()([x.permute(0, 4, 1, 2, 3) for x in inputs])
        got = model.eval()(inputs)
    scale = max(1.0, want.abs().max().item())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4 * scale)


def _abstract_shapes(tree):
    """A ShapeDtypeStruct tree as zero-stride numpy arrays of its shapes."""
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree)


@functools.lru_cache(maxsize=None)
def _jax_export(name, wm, groups, alpha, beta, norm="batchnorm", splits=1):
    """{torch name: shape} of JAX's export of the model (400 classes), and
    its variables' shapes, from ``jax.eval_shape`` of its init (no
    compile), at 8-frame 32² inputs: the families' weights do not depend
    on the input size."""
    cfg = jax_get_cfg()
    cfg.MODEL.MODEL_NAME, cfg.MODEL.NUM_CLASSES = name, 400
    cfg.SLOWFAST.WIDTH_MULTI, cfg.SLOWFAST.GROUPS = wm, groups
    cfg.SLOWFAST.ALPHA, cfg.SLOWFAST.BETA_INV = alpha, beta
    cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS = norm, splits
    cfg.TPU.DATA_AXIS = 1  # JAX multiplies the splits by the data axis
    x = [jax.ShapeDtypeStruct((2, 8 // alpha, 32, 32, 3), jnp.float32),
         jax.ShapeDtypeStruct((2, 8, 32, 32, 3), jnp.float32)]
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(functools.partial(
        jax_build_model(cfg).init, train=False),
        {"params": rng, "dropout": rng}, x)
    shapes = _abstract_shapes(dict(shapes))
    sd = export_torch_state_dict(shapes["params"],
                                 shapes.get("batch_stats", {}), cfg)
    return {k: tuple(v.shape) for k, v in sd.items()}, shapes


def _signature(cfg):
    s = cfg.SLOWFAST
    return (cfg.MODEL.MODEL_NAME, float(s.WIDTH_MULTI), s.GROUPS, s.ALPHA,
            s.BETA_INV)


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_builds_with_jax_names_and_shapes(path):
    """JAX's export is traced once for each (model, width, groups, α, β)
    among the yamls, at 400 classes; the classifier's rows follow the
    yaml's MODEL.NUM_CLASSES."""
    cfg = load_cfg(os.path.join(ROOT, path))
    assert cfg.DATA.INPUT_CHANNEL_NUM == [3, 3]
    model = build_model(cfg, device="cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    want = dict(_jax_export(*_signature(cfg))[0])
    width = want["head.classifier.1.weight"][1]
    want["head.classifier.1.weight"] = (cfg.MODEL.NUM_CLASSES, width)
    want["head.classifier.1.bias"] = (cfg.MODEL.NUM_CLASSES,)
    assert got.keys() == want.keys(), (sorted(got.keys() - want.keys())[:5],
                                       sorted(want.keys() - got.keys())[:5])
    assert got == want


def test_yaml_sweep_covers_every_family():
    names = {load_cfg(os.path.join(ROOT, p)).MODEL.MODEL_NAME for p in YAMLS}
    assert names == set(_FAMILIES) and len(YAMLS) >= 19


def test_sub_batchnorm_under_sequential_names():
    """ShuffleNetV2 w0.25 with BN.NORM_TYPE sub_batchnorm (2 splits): the
    split BNs sit under Sequential-index names (``….banch2.1``); the bridge
    maps them to JAX's tree (split statistics included), and the plain and
    split forms of the state_dict convert into each other's model
    strictly."""
    path = os.path.join(ROOT, "configs", "Synthetic", "SHUFFLENETV2_TINY.yaml")
    cfg = load_cfg(path, ["BN.NORM_TYPE", "sub_batchnorm", "BN.NUM_SPLITS", 2,
                          "MODEL.NUM_CLASSES", 400])
    model = build_model(cfg, device="cpu")
    subs = [n for n, m in model.named_modules()
            if isinstance(m, SubBatchNorm3d)]
    assert "s2.pathway0_channel_32.features.1.banch2.1" in subs
    _, shapes = _jax_export(*_signature(cfg), "sub_batchnorm", 2)
    got = state_dict_to_jax_variables(model.state_dict(), cfg)
    assert jax.tree_util.tree_map(np.shape, got) == jax.tree_util.tree_map(
        np.shape, {"params": shapes["params"],
                   "batch_stats": shapes["batch_stats"]})

    plain_cfg = load_cfg(path, ["MODEL.NUM_CLASSES", 400])
    plain = build_model(plain_cfg, device="cpu")
    flat = sub_to_normal_bn(model.state_dict())
    assert flat.keys() == plain.state_dict().keys()
    plain.load_state_dict(flat, strict=True)
    model.load_state_dict(normal_to_sub_bn(plain.state_dict(), 2),
                          strict=True)


def _jax_state(family, variables):
    jcfg = efficient_cfg(family, jax_get_cfg, train=True)
    tx, _ = jax_construct_optimizer(jcfg, variables["params"])
    return jcfg, JaxTrainState(step=jnp.zeros((), jnp.int32),
                               params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=tx.init(variables["params"]))


@pytest.mark.parametrize("family", ["shufflenetv2", "ghostnet"])
def test_checkpoints_cross_between_the_packages(family, tmp_path):
    cfg = efficient_cfg(family, train=True)
    variables = efficient_variables(cfg)
    jcfg, jstate = _jax_state(family, variables)
    path = jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), jstate, 2,
                                          jcfg)
    cfg.TEST.CHECKPOINT_FILE_PATH, cfg.TEST.CHECKPOINT_TYPE = path, "jax"
    model = build_model(cfg, device="cpu")
    checkpoint.load_test_checkpoint(cfg, model)
    want = jax_variables_to_state_dict(variables, cfg)
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(value, want[key]), key

    # the port's .pyth (reference layout) into JAX's variables
    state = create_train_state(cfg, model, device="cpu")
    cfg.OUTPUT_DIR = str(tmp_path / "port")
    pyth = checkpoint.save_checkpoint(cfg.OUTPUT_DIR, state, 3, cfg)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    params, stats = load_torch_checkpoint(jcfg, pyth, zeros["params"],
                                          zeros["batch_stats"])
    got = flat_leaves({"params": params, "batch_stats": stats})
    for key, value in flat_leaves(variables).items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
