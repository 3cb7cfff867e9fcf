"""The port's AVA detection models and train step against the JAX
package's on the same weights (the port's seeded init carried across by
the weight bridge) and inputs, f32 on the CPU, rtol = atol = 1e-4: the RoI
head, the detection forward of SlowFast, ResNet (the slow pathway alone)
and SlowFastDualAttention (CMDA) with s5 at stride 1 and dilation 2 as the
AVA yamls build it, ``make_detection_train_step`` plain and with
``TPU.GRAD_ACCUM_STEPS`` 2, and the bridge's RoI head names both ways.

The configs are ``tests/test_ava.py::tiny_detection_cfg`` (SlowFast R18,
basic blocks, width 8, 4 frames) with each model's changes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.engine.state import TrainState as JaxTrainState
from efficient_slowfast_tpu.engine.state import \
    _flatten_rois as jax_flatten_rois
from efficient_slowfast_tpu.engine.state import \
    make_detection_train_step as jax_make_detection_train_step
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu.models.detection import \
    ResNetRoIHead as JaxRoIHead
from efficient_slowfast_tpu.models.optimizer import \
    construct_optimizer as jax_construct_optimizer
from efficient_slowfast_tpu.utils.torch_ckpt import export_torch_state_dict
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.config.node import CfgNode
from efficient_slowfast_tpu_torch.engine.state import (
    create_train_state, flatten_rois, make_detection_forward,
    make_detection_train_step)
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.models.detection import ResNetRoIHead
from efficient_slowfast_tpu_torch.utils.weights import (
    jax_variables_to_state_dict, state_dict_to_jax_variables)
from test_ava import make_ava_fixture, tiny_detection_cfg
from torch_port_helpers import compiled, flat_leaves, seeded_variables

TOL = dict(rtol=1e-4, atol=1e-4)
CANVAS = (32, 64)  # the serving canvas: short side 32, twice as wide
# (R, 5) boxes of a 2-clip batch of 3 slots, in canvas pixels: real boxes,
# one on the canvas's edges, and a zero-padded slot
BOXES = np.array([[[2.0, 3.0, 30.0, 28.0], [20.0, 0.0, 63.0, 31.0],
                   [0.0, 0.0, 0.0, 0.0]],
                  [[10.5, 4.2, 50.1, 22.9], [0.0, 0.0, 0.0, 0.0],
                   [40.0, 8.0, 58.0, 30.0]]], np.float32)


def plain(node):
    return {k: plain(v) if hasattr(v, "items") else v for k, v in node.items()}


def to_port(jcfg):
    """The port's config of the same values as the JAX package's."""
    cfg = get_cfg()
    cfg.merge_from_other_cfg(CfgNode(plain(jcfg)))
    return cfg


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return make_ava_fixture(tmp_path_factory.mktemp("ava"))


def det_cfg(fx, model):
    """(JAX cfg, port cfg) of ``model``: tiny_detection_cfg, s5 at stride 1
    and dilation 2 (the AVA yamls' s5), no dropout."""
    jcfg = tiny_detection_cfg(fx)
    jcfg.MODEL.DROPOUT_RATE = 0.0
    jcfg.TPU.DONATE = False
    jcfg.RESNET.SPATIAL_STRIDES = [[1, 1], [2, 2], [2, 2], [1, 1]]
    jcfg.RESNET.SPATIAL_DILATIONS = [[1, 1]] * 3 + [[2, 2]]
    if model == "resnet":
        jcfg.MODEL.MODEL_NAME, jcfg.MODEL.ARCH = "ResNet", "slow"
        jcfg.DATA.INPUT_CHANNEL_NUM = [3]
        for key in ("NUM_BLOCK_TEMP_KERNEL", "SPATIAL_STRIDES",
                    "SPATIAL_DILATIONS"):
            setattr(jcfg.RESNET, key,
                    [v[:1] for v in getattr(jcfg.RESNET, key)])
        jcfg.NONLOCAL.LOCATION = [[[]]] * 4
        jcfg.NONLOCAL.GROUP = [[1]] * 4
        jcfg.NONLOCAL.POOL = [[[1, 2, 2]]] * 4
    elif model == "cmda":
        # its s1/s2 fusions attend over 512 slow tokens: above 256 the
        # streaming path (flash_attention's plain version here, JAX's
        # chunked_attention)
        jcfg.MODEL.MODEL_NAME = "SlowFastDualAttention"
        jcfg.RESNET.WIDTH_PER_GROUP = 16
        jcfg.TPU.FLASH_MIN_TOKENS = 256
    return jcfg, to_port(jcfg)


def inputs_np(cfg, batch, hw, seed=0):
    rs = np.random.RandomState(seed)
    t = cfg.DATA.NUM_FRAMES
    frames = ([t] if cfg.MODEL.MODEL_NAME == "ResNet"
              else [t // cfg.SLOWFAST.ALPHA, t])
    return [rs.rand(batch, f, *hw, 3).astype(np.float32) for f in frames]


def test_flatten_rois_matches_jax():
    got = flatten_rois(torch.from_numpy(BOXES)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_flatten_rois(BOXES)))
    assert got.shape == (6, 5) and list(got[:, 0]) == [0, 0, 0, 1, 1, 1]


@pytest.mark.parametrize("act", ["sigmoid", "softmax"])
def test_roi_head_matches_jax(act):
    rs = np.random.RandomState(0)
    feats = [rs.randn(2, 2, 4, 8, 16).astype(np.float32),
             rs.randn(2, 8, 4, 8, 4).astype(np.float32)]  # (B, T, H, W, C)
    rois = jax_flatten_rois(BOXES)
    kw = dict(num_classes=5, pool_size=[[2, 1, 1], [8, 1, 1]],
              resolution=[[7, 7]] * 2, scale_factor=[8, 8], act_func=act)
    jhead = JaxRoIHead(**kw)
    variables = jhead.init(jax.random.PRNGKey(0), feats, rois)
    ref = np.asarray(jhead.apply(variables, feats, rois))
    head = ResNetRoIHead(dim_in=[16, 4], **kw)
    fc = variables["params"]["projection"]["fc"]
    with torch.no_grad():
        head.projection.weight.copy_(torch.from_numpy(np.array(fc["kernel"]).T))
        head.projection.bias.copy_(torch.from_numpy(np.array(fc["bias"])))
    ncdhw = [torch.from_numpy(f).permute(0, 4, 1, 2, 3) for f in feats]
    for train in (False, True):  # the activation in both modes
        out = head.train(train)(ncdhw, torch.from_numpy(np.array(rois)))
        assert out.dtype == torch.float32 and out.shape == (6, 5)
        np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)


@pytest.mark.parametrize("model", ["slowfast", "resnet", "cmda"])
def test_detection_forward_matches_jax(fx, model):
    jcfg, cfg = det_cfg(fx, model)
    variables = seeded_variables(cfg)
    inputs = inputs_np(cfg, 2, CANVAS)
    jmodel = jax_build_model(jcfg)
    ref = np.asarray(jax.jit(lambda v, x, r: jmodel.apply(
        v, x, r, train=False))(variables, [jnp.asarray(x) for x in inputs],
                               jax_flatten_rois(BOXES)))
    port = build_model(cfg, device="cpu")
    port.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    fwd = make_detection_forward(cfg, port, device="cpu")
    out = fwd([torch.from_numpy(x) for x in inputs], torch.from_numpy(BOXES))
    assert out.shape == (6, 80) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert np.ptp(ref, axis=0).max() > 1e-3  # the boxes' scores differ
    # the bridge's names of the RoI head, both ways and through JAX's export
    sd = port.state_dict()
    assert "head.projection.weight" in sd and sd["head.projection.weight"].shape[0] == 80
    back = state_dict_to_jax_variables(sd)
    np.testing.assert_array_equal(
        back["params"]["head"]["projection"]["fc"]["kernel"],
        variables["params"]["head"]["projection"]["fc"]["kernel"])
    exported = export_torch_state_dict(variables["params"],
                                       variables["batch_stats"])
    build_model(cfg, device="cpu").load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in exported.items()},
        strict=True)


def test_detection_forward_needs_boxes(fx):
    _, cfg = det_cfg(fx, "slowfast")
    model = build_model(cfg, device="cpu").eval()
    with pytest.raises(ValueError, match="boxes"):
        model([torch.from_numpy(x) for x in inputs_np(cfg, 2, CANVAS)])


def train_cfgs(fx, accum):
    jcfg, _ = det_cfg(fx, "slowfast")
    jcfg.SOLVER.OPTIMIZING_METHOD = "sgd"
    jcfg.SOLVER.BASE_LR = 0.01
    jcfg.SOLVER.MOMENTUM = 0.9
    jcfg.SOLVER.NESTEROV = True
    jcfg.SOLVER.DAMPENING = 0.0
    jcfg.SOLVER.WEIGHT_DECAY = 1e-4
    jcfg.BN.WEIGHT_DECAY = 0.0
    jcfg.MODEL.LOSS_FUNC = "bce"
    jcfg.TPU.GRAD_ACCUM_STEPS = accum
    return jcfg, to_port(jcfg)


@pytest.mark.parametrize("accum", [1, 2])
def test_detection_train_step_matches_jax(fx, accum):
    """One step on 4 clips of 2 box slots, the real boxes spread unevenly
    (3, 1, 1, 0: with accumulation 3 in the first microbatch, 1 in the
    second), at lr 0.01: the loss, every parameter and BN statistic."""
    jcfg, cfg = train_cfgs(fx, accum)
    variables = seeded_variables(cfg)
    s = cfg.DATA.CROP_SIZE
    inputs = inputs_np(cfg, 4, (s, s), seed=3)
    rs = np.random.RandomState(4)
    xy = np.sort(rs.uniform(0, s - 1, (4, 2, 2, 2)), axis=2)
    boxes = np.stack([xy[..., 0, 0], xy[..., 0, 1], xy[..., 1, 0],
                      xy[..., 1, 1]], -1).astype(np.float32)
    labels = (rs.rand(4, 2, 80) < 0.1).astype(np.float32)
    mask = np.array([[1, 1], [1, 0], [1, 0], [0, 0]], np.float32)
    boxes *= mask[..., None]  # padded slots are all zeros

    jmodel = jax_build_model(jcfg)
    tx, _ = jax_construct_optimizer(jcfg, variables["params"])
    jstep = jax_make_detection_train_step(jcfg, jmodel, tx)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    jstate, jmets = compiled(jstep, jstate, [jnp.asarray(x) for x in inputs],
                             boxes, labels, mask, 0.01, jax.random.PRNGKey(0))

    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    state = create_train_state(cfg, model, device="cpu")
    step = make_detection_train_step(cfg, state.model, state.optimizer)
    mets = step(state, [torch.from_numpy(x) for x in inputs],
                torch.from_numpy(boxes), torch.from_numpy(labels),
                torch.from_numpy(mask), 0.01)
    assert state.step == 1
    np.testing.assert_allclose(float(mets["loss"]), float(jmets["loss"]),
                               **TOL)
    assert float(mets["lr"]) == pytest.approx(0.01)
    ours = flat_leaves(state_dict_to_jax_variables(state.model.state_dict()))
    theirs = flat_leaves({"params": jstate.params,
                          "batch_stats": jstate.batch_stats})
    assert ours.keys() == theirs.keys()
    moved = 0
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], err_msg=k, **TOL)
        moved += not np.array_equal(theirs[k], flat_leaves(variables)[k])
    assert moved > len(theirs) // 2  # the step moved most tensors


@pytest.mark.parametrize("loss", ["bce_logit", "cross_entropy"])
def test_detection_train_step_refuses_a_loss_that_is_not_elementwise(
        fx, loss):
    """The RoI head's train scores are probabilities: ``bce_logit`` would
    take a second sigmoid, and a loss without an elementwise form cannot be
    masked per box; both raise when the step is built, as in JAX."""
    _, cfg = train_cfgs(fx, 1)
    cfg.MODEL.LOSS_FUNC = loss
    state = create_train_state(cfg, build_model(cfg, device="cpu"),
                               device="cpu")
    with pytest.raises(NotImplementedError, match=loss):
        make_detection_train_step(cfg, state.model, state.optimizer)
