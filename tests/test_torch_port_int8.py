"""The port's int8 serving (TPU.INT8_EVAL, TPU.INT8_SPATIAL: ops/conv.py's
int8 convs over ops/kernels/int8_conv.py, engine/quantize.py) against the
JAX package's, f32 on the CPU, where the int8 op runs its plain version.

Each int8 layer, on the same float32 weights and inputs, must give JAX's
calibrated range, JAX's int8 codes and int32 accumulators bit for bit (JAX
jitted, as it serves: XLA rewrites the divisions by 127 as products with
the reciprocal, which the port follows) and JAX's output within 1e-6 of
its scale; no point on a .5 tie needs excluding, as both sides divide in
IEEE float32 and round half to even."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.engine.quantize import \
    calibrate_int8 as jax_calibrate
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu.ops import options as jax_options
from efficient_slowfast_tpu.ops.conv import Conv3d as JaxConv3d
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.config.defaults import assert_and_infer_cfg
from efficient_slowfast_tpu_torch.engine import quantize
from efficient_slowfast_tpu_torch.engine.state import make_forward
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.ops.conv import (Conv3d, enable_int8,
                                                   int8_convs,
                                                   quant_is_calibrated)
from efficient_slowfast_tpu_torch.ops.kernels.int8_conv import (
    activation_codes, int8_conv, int8_conv_accumulator)
from efficient_slowfast_tpu_torch.utils.weights import (
    jax_quant_to_port, jax_variables_to_state_dict, port_quant_to_jax)
from torch_port_helpers import seeded_variables

# (label, Cin, Cout, kernel, stride, padding, input dtype)
LAYERS = [("pointwise", 16, 24, (1, 1, 1), (1, 1, 1), (0, 0, 0), "float32"),
          ("strided projection", 16, 32, (1, 1, 1), (1, 2, 2), (0, 0, 0),
           "float32"),
          ("padded 1x3x3", 8, 12, (1, 3, 3), (1, 1, 1), (0, 1, 1), "float32"),
          ("stem 1x7x7", 3, 8, (1, 7, 7), (1, 2, 2), (0, 3, 3), "float32"),
          ("bf16 pointwise", 16, 24, (1, 1, 1), (1, 2, 2), (0, 0, 0),
           "bfloat16")]


@pytest.fixture
def jax_int8():
    saved = (jax_options.options.int8_eval, jax_options.options.int8_spatial)
    jax_options.options.int8_eval = jax_options.options.int8_spatial = True
    yield
    jax_options.options.int8_eval, jax_options.options.int8_spatial = saved


def _jax_layer(cin, cout, k, s, p, dtype, kernel, bias, x):
    """JAX's int8 conv, jitted: (act_max, codes xq, codes wq, acc, y), the
    operands and result of its int8 dot_general / conv_general_dilated
    captured as it serves."""
    m = JaxConv3d(features=cout, kernel_size=k, stride=s, padding=p,
                  use_bias=True, dtype=getattr(jnp, dtype))
    params = {"conv": {"kernel": kernel, "bias": bias}}
    _, quant = jax.jit(lambda v, x: m.apply(v, x, mutable=["quant"]))(
        {"params": params}, x)
    seen = []
    real = {name: getattr(jax.lax, name)
            for name in ("dot_general", "conv_general_dilated")}

    def spy(name):
        def op(lhs, rhs, *a, **kw):
            out = real[name](lhs, rhs, *a, **kw)
            if kw.get("preferred_element_type") == jnp.int32:
                seen.append((lhs, rhs, out))
            return out
        return op

    def serve(v, x):
        seen.clear()
        y = m.apply(v, x)
        return y, seen[0]

    try:
        for name in real:
            setattr(jax.lax, name, spy(name))
        y, (xq, wq, acc) = jax.jit(serve)(
            {"params": params, "quant": quant["quant"]}, x)
    finally:
        for name, fn in real.items():
            setattr(jax.lax, name, fn)
    return (float(quant["quant"]["conv"]["act_max"]), np.asarray(xq),
            np.asarray(wq), np.asarray(acc), np.asarray(y, np.float32))


@pytest.mark.parametrize("label, cin, cout, k, s, p, dtype", LAYERS)
def test_int8_layer_matches_jax_codes_and_accumulators(
        jax_int8, label, cin, cout, k, s, p, dtype):
    rs = np.random.RandomState(len(label))
    kernel = (rs.randn(*k, cin, cout) / np.sqrt(np.prod(k) * cin)).astype(
        np.float32)
    bias = (0.1 * rs.randn(cout)).astype(np.float32)
    x = rs.randn(2, 4, 10, 10, cin).astype(np.float32)
    x_in = jnp.asarray(x, getattr(jnp, dtype))
    act_max, xq, wq, acc, y = _jax_layer(cin, cout, k, s, p, dtype, kernel,
                                         bias, x_in)

    cfg = get_cfg()
    cfg.TPU.INT8_EVAL = cfg.TPU.INT8_SPATIAL = True
    tdtype = getattr(torch, dtype)
    conv = enable_int8(Conv3d(cin, cout, k, s, p, bias=True, dtype=tdtype),
                       cfg)
    assert conv.int8 == ("pointwise" if k == (1, 1, 1) else "spatial")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel).permute(4, 3, 0, 1, 2))
        conv.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(np.array(x_in.astype(jnp.float32))).to(
        tdtype).permute(0, 4, 1, 2, 3)
    quantize.calibrate_int8(conv, [(xt,)])
    assert float(conv.act_max) == act_max

    ndhwc = lambda t: t.permute(0, 2, 3, 4, 1).numpy()  # noqa: E731
    strided = xt[:, :, ::s[0], ::s[1], ::s[2]] if conv.int8 == "pointwise" \
        else xt
    np.testing.assert_array_equal(
        ndhwc(activation_codes(strided, conv.act_max)), xq)
    codes, _ = conv.weight_codes()
    ours_wq = codes[:, :np.prod(k) * cin].reshape(cout, *k, cin).permute(
        1, 2, 3, 4, 0).numpy()
    np.testing.assert_array_equal(ours_wq, wq.reshape(ours_wq.shape))
    np.testing.assert_array_equal(ndhwc(int8_conv_accumulator(
        xt, codes, conv.act_max, k, s, p)), acc)
    before = int8_conv.launches
    with torch.no_grad():
        ours = ndhwc(conv(xt).float())
    assert int8_conv.launches == before  # the plain version on the CPU
    scale = np.abs(y).max()
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8  # bf16: one ulp
    np.testing.assert_allclose(ours, y, rtol=0, atol=tol * scale)


def _tiny(get, int8=True, spatial=False):
    """tests/test_int8_eval.py:100-140's SlowFast-R18, width 8, f32."""
    cfg = get()
    cfg.MODEL.MODEL_NAME, cfg.MODEL.ARCH = "SlowFast", "slowfast"
    cfg.RESNET.DEPTH, cfg.RESNET.TRANS_FUNC = 18, "basic_transform"
    cfg.RESNET.WIDTH_PER_GROUP = 8
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[2, 2]] * 4
    cfg.RESNET.SPATIAL_STRIDES = [[1, 1], [2, 2], [2, 2], [2, 2]]
    cfg.RESNET.SPATIAL_DILATIONS = [[1, 1]] * 4
    cfg.NONLOCAL.LOCATION = [[[], []]] * 4
    cfg.NONLOCAL.GROUP = [[1, 1]] * 4
    cfg.NONLOCAL.POOL = [[[1, 2, 2], [1, 2, 2]]] * 4
    cfg.SLOWFAST.ALPHA, cfg.SLOWFAST.BETA_INV = 4, 8
    cfg.MODEL.NUM_CLASSES = 10
    cfg.DATA.NUM_FRAMES = 8
    cfg.DATA.CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.INT8_EVAL, cfg.TPU.INT8_SPATIAL = int8, spatial
    return cfg


def _inputs(batch=4, seed=1):
    rs = np.random.RandomState(seed)
    return [rs.randn(batch, 2, 32, 32, 3).astype(np.float32),
            rs.randn(batch, 8, 32, 32, 3).astype(np.float32)]


def _port(cfg, variables):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return model


# The tiny model against JAX. Both calibrate their float paths, which agree
# to float32 rounding, so the ranges agree to 1e-5 (measured 2.8e-6); from
# there a code whose x / s_act falls within that rounding of a .5 boundary
# flips on one side by one step, and each flip moves the layers after it:
# code flips cascade. So the port's probabilities are held to JAX's by a
# distance ratio: max |port - JAX int8| within a quarter of max |JAX int8 -
# JAX float|, the int8 error itself, on the port's own ranges and on JAX's
# (measured 0.125 and 0.125 under INT8_EVAL, 0.15 and 2e-5 under
# +INT8_SPATIAL, whose layers are nearly all exact integer sums). A wrong
# layer choice, calibration input or dequantization moves them by the int8
# error or more. Top-1 must agree.
TINY_RATIO = 0.25


def _serve(model):
    return jax.jit(lambda v, x: model.apply(v, x, train=False))


@pytest.fixture(scope="module")
def tiny_float():
    """The tiny model's weights, inputs and JAX float32 probabilities."""
    variables = seeded_variables(_tiny(get_cfg, int8=False))
    inputs = _inputs()
    jfloat = jax_build_model(_tiny(jax_get_cfg, int8=False))
    ref = np.asarray(_serve(jfloat)(variables,
                                    [jnp.asarray(x) for x in inputs]))
    return variables, inputs, ref


@pytest.mark.parametrize("spatial", [False, True])
def test_tiny_slowfast_int8_matches_jax(jax_int8, tiny_float, spatial):
    variables, inputs, ref = tiny_float
    jx = [jnp.asarray(x) for x in inputs]
    jax_options.options.int8_spatial = spatial
    jmodel = jax_build_model(_tiny(jax_get_cfg, spatial=spatial))
    jvars = jax_calibrate(jmodel, variables, [jx])
    want = np.asarray(_serve(jmodel)(jvars, jx))
    bound = TINY_RATIO * np.abs(want - ref).max()

    cfg = _tiny(get_cfg, spatial=spatial)
    model = _port(cfg, variables)
    assert not quant_is_calibrated(model)
    quant = quantize.calibrate_int8(
        model, [[torch.from_numpy(x) for x in inputs]])
    theirs = jax_quant_to_port(jax.device_get(jvars["quant"]))
    assert set(quant) == set(theirs)
    for name, value in quant.items():
        np.testing.assert_allclose(float(value), float(theirs[name]),
                                   rtol=1e-5, err_msg=name)
    for ranges in (quant, theirs):
        quantize.load_quant_state(model, ranges)
        got = make_forward(cfg, model, device="cpu")(
            [torch.from_numpy(x) for x in inputs]).numpy()
        assert np.abs(got - want).max() <= bound
        assert (got.argmax(-1) == want.argmax(-1)).all()


def test_quant_bridge_carries_both_ways(jax_int8):
    """JAX's quant collection → the port's quant state → back, for every
    int8 conv of the tiny model (stems included under INT8_SPATIAL)."""
    cfg = _tiny(get_cfg, spatial=True)
    model = build_model(cfg, device="cpu")
    names = {f"{n}.act_max" for n in int8_convs(model)}
    rs = np.random.RandomState(0)
    quant = {n: torch.tensor(np.float32(rs.rand() + 0.5)) for n in names}
    tree = port_quant_to_jax(quant)
    back = jax_quant_to_port(tree)
    assert set(back) == names
    assert all(float(back[n]) == float(quant[n]) for n in names)
    jmodel = jax_build_model(_tiny(jax_get_cfg, spatial=True))
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(0)},
                            [jnp.zeros((1, 2, 32, 32, 3)),
                             jnp.zeros((1, 8, 32, 32, 3))], train=False))
    jax_paths = {"/".join(k.key for k in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(shapes["quant"])[0]}
    ours = {"/".join(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert ours == jax_paths
    quantize.load_quant_state(model, back)
    assert quant_is_calibrated(model)


def test_refusals():
    cfg = _tiny(get_cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="not calibrated"):
        make_forward(cfg, model, device="cpu")
    cfg.TRAIN.ENABLE = False
    cfg.TPU.FUSED_EVAL = True
    with pytest.raises(AssertionError):
        make_forward(cfg, model, device="cpu")
    with pytest.raises(AssertionError, match="mutually exclusive"):
        assert_and_infer_cfg(cfg)
    cfg.TPU.FUSED_EVAL = False
    cfg.TRAIN.ENABLE = True
    with pytest.raises(AssertionError, match="INT8_EVAL"):
        assert_and_infer_cfg(cfg)
    with pytest.raises(ValueError, match="INT8_EVAL"):
        quantize.calibrate_int8(build_model(_tiny(get_cfg, int8=False),
                                            device="cpu"), [])


def test_int8_is_chosen_by_enable_int8_alone():
    """A conv is int8 only after enable_int8 with TPU.INT8_EVAL: a model
    built with it leaves a conv built afterwards float, and the knobs off
    give no int8 conv and no quant buffer."""
    int8_model = build_model(_tiny(get_cfg), device="cpu")
    assert int8_convs(int8_model)
    assert Conv3d(8, 8, (1, 1, 1)).int8 is None
    float_model = build_model(_tiny(get_cfg, int8=False), device="cpu")
    assert not int8_convs(float_model)
    assert not any(name.endswith("act_max")
                   for name, _ in float_model.named_buffers())
    cfg = get_cfg()
    cfg.TPU.INT8_EVAL = True
    pointwise = enable_int8(Conv3d(8, 8, (1, 1, 1), stride=(1, 2, 2)), cfg)
    spatial = enable_int8(Conv3d(8, 8, (1, 3, 3), padding=(0, 1, 1)), cfg)
    grouped = enable_int8(Conv3d(8, 8, (1, 1, 1), groups=2), cfg)
    assert (pointwise.int8, spatial.int8, grouped.int8) == (
        "pointwise", None, None)
    cfg.TPU.INT8_SPATIAL = True
    assert enable_int8(spatial, cfg).int8 == "spatial"


def test_weight_codes_follow_the_weight():
    """The cached weight codes are not served stale: a load_state_dict (an
    in-place write) or a move requantizes; a new act_max needs nothing."""
    cfg = _tiny(get_cfg)
    model = build_model(cfg, device="cpu")
    conv = int8_convs(model)["s2.pathway0_res0.branch1"]
    codes, _ = conv.weight_codes()
    assert conv.weight_codes()[0] is codes
    sd = model.state_dict()
    sd["s2.pathway0_res0.branch1.weight"] = -sd[
        "s2.pathway0_res0.branch1.weight"]
    model.load_state_dict(sd)
    fresh, _ = conv.weight_codes()
    assert torch.equal(fresh, -codes)


def test_fingerprint_tracks_weight_values(tmp_path):
    cfg = _tiny(get_cfg)
    cfg.OUTPUT_DIR = str(tmp_path)
    model = build_model(cfg, device="cpu")
    quant = {f"{n}.act_max": torch.tensor(2.5)
             for n in int8_convs(model)}
    path = quantize.save_calibration(cfg, model, quant)
    assert path.endswith("int8_calibration.torch.msgpack")
    got = quantize.load_calibration(cfg, model)
    assert got is not None and set(got) == set(quant)
    assert all(float(v) == 2.5 for v in got.values())
    with torch.no_grad():
        model.head.projection.weight.mul_(1.01)
    assert quantize.load_calibration(cfg, model) is None
    with torch.no_grad():
        model.head.projection.weight.div_(1.01)
    cfg.DATA.TEST_CROP_SIZE += 32
    assert quantize.load_calibration(cfg, model) is None


def test_test_engine_auto_calibrates_and_persists(tmp_path, monkeypatch):
    """test() with TPU.INT8_EVAL calibrates on TPU.INT8_CALIB_BATCHES test
    batches, persists, serves every view; a second run loads the file; a
    change of INT8_SPATIAL recalibrates."""
    test_mod = importlib.import_module("efficient_slowfast_tpu_torch.engine.test")
    cfg = _tiny(get_cfg)
    cfg.TRAIN.ENABLE = False
    cfg.TEST.DATASET = "synthetic"
    cfg.TEST.BATCH_SIZE = 4
    cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = 1, 1
    cfg.TPU.INT8_CALIB_BATCHES = 2
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg = assert_and_infer_cfg(cfg)
    calls = []
    real = quantize.calibrate_for_test
    monkeypatch.setattr(quantize, "calibrate_for_test",
                        lambda *a: calls.append(1) or real(*a))
    meter = test_mod.test(cfg, device="cpu")
    assert meter.stats["_type"] == "test_final"
    assert np.isfinite(meter.video_preds).all()
    assert calls == [1]
    path = quantize.calibration_path(cfg)
    saved = open(path, "rb").read()
    meter2 = test_mod.test(cfg, device="cpu")
    assert calls == [1] and open(path, "rb").read() == saved
    np.testing.assert_array_equal(meter2.video_preds, meter.video_preds)
    cfg.TPU.INT8_SPATIAL = True
    test_mod.test(cfg, device="cpu")
    assert calls == [1, 1]
