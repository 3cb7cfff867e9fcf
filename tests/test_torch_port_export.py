"""The port's serving export (engine/export.py, tools/export_serving.py)
round trips through torch.export, as tests/test_export.py holds JAX's
through jax.export: an artifact at a symbolic batch serves any batch
(1 included) as the live forward does, on the CPU, where the kernel ops
in the graph (K1 esf_torch::fused_bottleneck, K2
esf_torch::flash_attention, K3 esf_torch::int8_conv) run their plain
versions; the classification artifact is also held against JAX's artifact
of the same weights. And the kernel ops' FLOP formulas count what their
plain versions count (utils/misc.py)."""

import logging
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.engine.export import \
    export_serving as jax_export_serving
from efficient_slowfast_tpu.engine.export import \
    load_serving as jax_load_serving
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.engine import quantize
from efficient_slowfast_tpu_torch.engine.export import (export_serving,
                                                        load_serving)
from efficient_slowfast_tpu_torch.engine.inference import \
    make_fused_eval_forward
from efficient_slowfast_tpu_torch.engine.state import (make_detection_forward,
                                                       make_forward,
                                                       pathway_inputs)
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.ops.kernels.fused_bottleneck import \
    fused_bottleneck
from efficient_slowfast_tpu_torch.tools import export_serving as export_cli
from efficient_slowfast_tpu_torch.utils import misc
from efficient_slowfast_tpu_torch.utils.weights import \
    jax_variables_to_state_dict
from torch_port_helpers import seeded_variables, small_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(get=get_cfg, detection=False):
    """tests/test_export.py:_det_cfg's SlowFast-R18 (width 8, 4 frames,
    32², f32); 10 softmax classes, or 80 sigmoid ones for detection."""
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
    cfg.DATA.NUM_FRAMES = 4
    cfg.DATA.CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TRAIN.ENABLE = False
    cfg.MODEL.NUM_CLASSES = 10
    if detection:
        cfg.DETECTION.ENABLE = True
        cfg.MODEL.NUM_CLASSES, cfg.MODEL.HEAD_ACT = 80, "sigmoid"
    return cfg


def _inputs(cfg, b, seed=0):
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    r = np.random.RandomState(seed)
    return [r.randn(b, t // cfg.SLOWFAST.ALPHA, s, s, 3).astype(np.float32),
            r.randn(b, t, s, s, 3).astype(np.float32)]


def _boxes(cfg, b, max_boxes, seed):
    s = cfg.DATA.TEST_CROP_SIZE
    r = np.random.RandomState(10 + seed)
    x1y1 = r.uniform(0, s / 2, (b, max_boxes, 2))
    wh = r.uniform(2, s / 2, (b, max_boxes, 2))
    return np.concatenate([x1y1, x1y1 + wh], -1).astype(np.float32)


def _tensors(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _graph_ops(serving):
    graph = str(serving.program.graph)
    return {op: graph.count(f"esf_torch.{op}.default") for op in
            ("fused_bottleneck", "flash_attention", "int8_conv")}


def _model(cfg, variables=None):
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    if variables is not None:
        model.load_state_dict(jax_variables_to_state_dict(variables))
    return model


def test_export_roundtrip_symbolic_batch(tmp_path):
    """Export → load → serve at three batch sizes (1 padded to the
    artifact's least 2): the live forward's scores, and JAX's artifact's
    of the same weights (f32 parity, 1e-4)."""
    cfg = _tiny()
    variables = seeded_variables(cfg)
    model = _model(cfg, variables)
    path = export_serving(cfg, model, str(tmp_path / "tiny"), device="cpu")
    assert path.endswith(".pt2")
    serving = load_serving(path)
    fwd = make_forward(cfg, model, device="cpu")
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    jax_serving = jax_load_serving(jax_export_serving(
        _tiny(jax_get_cfg), state, str(tmp_path / "tiny")))
    for b in (1, 2, 5):
        x = _inputs(cfg, b, seed=b)
        got = serving(x)
        assert got.shape == (b, cfg.MODEL.NUM_CLASSES)
        np.testing.assert_allclose(got, fwd(_tensors(x)).numpy(), rtol=1e-5,
                                   atol=1e-6)
        if b > 1:  # each batch size compiles JAX's artifact anew
            np.testing.assert_allclose(got, jax_serving(
                [jnp.asarray(v) for v in x]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.sum(-1), np.ones(b), rtol=1e-4)


def test_export_detection_roundtrip_symbolic_batch(tmp_path):
    cfg = _tiny(detection=True)
    model = _model(cfg)
    max_boxes = 3
    path = export_serving(cfg, model, str(tmp_path / "det"),
                          max_boxes=max_boxes, device="cpu")
    serving = load_serving(path)
    fwd = make_detection_forward(cfg, model, device="cpu")
    for b in (1, 2, 4):
        x, boxes = _inputs(cfg, b, seed=b), _boxes(cfg, b, max_boxes, b)
        got = serving(x, boxes)
        assert got.shape == (b * max_boxes, cfg.MODEL.NUM_CLASSES)
        np.testing.assert_allclose(
            got, fwd(_tensors(x), torch.from_numpy(boxes)).numpy(),
            rtol=1e-5, atol=1e-6)
        assert got.min() > 0.0 and got.max() < 1.0


def _int8(cfg):
    cfg.TPU.INT8_EVAL = True
    return cfg


def test_export_int8_requires_calibration(tmp_path):
    cfg = _int8(_tiny())
    cfg.OUTPUT_DIR = str(tmp_path)
    with pytest.raises(AssertionError, match="calibrated"):
        export_serving(cfg, _model(cfg), str(tmp_path / "int8"), device="cpu")


def test_export_int8_calibrated_roundtrip(tmp_path):
    """A calibrated int8 graph (K3 in every int8 conv) exports and serves
    the live int8 forward's scores."""
    cfg = _int8(_tiny())
    cfg.TPU.INT8_SPATIAL = True
    model = _model(cfg)
    quant = quantize.calibrate_int8(model, [_tensors(_inputs(cfg, 2))])
    fresh = _model(cfg)
    path = export_serving(cfg, fresh, str(tmp_path / "int8"), quant=quant,
                          device="cpu")
    serving = load_serving(path)
    ops = _graph_ops(serving)
    assert ops["int8_conv"] == len(quant) and ops["fused_bottleneck"] == 0
    x = _inputs(cfg, 3, seed=7)
    np.testing.assert_allclose(
        serving(x),
        make_forward(cfg, model, device="cpu")(_tensors(x)).numpy(),
        rtol=1e-5, atol=1e-6)


def test_export_cmda_graph_holds_k2(tmp_path):
    cfg = small_cfg(model="SlowFastDualAttention", depth=18, width=8,
                    flash_min_tokens=16, trans="basic_transform")
    cfg.DATA.CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    model = _model(cfg)
    serving = load_serving(export_serving(cfg, model, str(tmp_path / "cmda"),
                                          device="cpu"))
    assert _graph_ops(serving) == {"fused_bottleneck": 0,
                                   "flash_attention": 3, "int8_conv": 0}
    x = _inputs(cfg, 2, seed=4)
    np.testing.assert_allclose(
        serving(x),
        make_forward(cfg, model, device="cpu")(_tensors(x)).numpy(),
        rtol=1e-5, atol=1e-6)


def test_export_fused_graph_holds_k1(tmp_path):
    """The fused engine's BN-folded tensors become the artifact's constants
    and each stride-1 bottleneck one K1 node (10 in an R18)."""
    cfg = small_cfg(fused=True, depth=18, width=8)
    model = _model(cfg)
    serving = load_serving(export_serving(cfg, model, str(tmp_path / "fused"),
                                          device="cpu"))
    assert _graph_ops(serving) == {"fused_bottleneck": 10,
                                   "flash_attention": 0, "int8_conv": 0}
    x = _inputs(cfg, 2, seed=5)
    before = fused_bottleneck.launches
    got = serving(x)
    assert fused_bottleneck.launches == before  # plain versions on the CPU
    np.testing.assert_allclose(
        got, make_forward(cfg, model, device="cpu")(_tensors(x)).numpy(),
        rtol=1e-5, atol=1e-6)


_TINY_YAML = """
MODEL: {MODEL_NAME: SlowFast, ARCH: slowfast, NUM_CLASSES: 10}
RESNET:
  DEPTH: 18
  TRANS_FUNC: basic_transform
  WIDTH_PER_GROUP: 8
  NUM_BLOCK_TEMP_KERNEL: [[2, 2], [2, 2], [2, 2], [2, 2]]
  SPATIAL_STRIDES: [[1, 1], [2, 2], [2, 2], [2, 2]]
  SPATIAL_DILATIONS: [[1, 1], [1, 1], [1, 1], [1, 1]]
NONLOCAL:
  LOCATION: [[[], []], [[], []], [[], []], [[], []]]
  GROUP: [[1, 1], [1, 1], [1, 1], [1, 1]]
  POOL: [[[1, 2, 2], [1, 2, 2]], [[1, 2, 2], [1, 2, 2]],
         [[1, 2, 2], [1, 2, 2]], [[1, 2, 2], [1, 2, 2]]]
SLOWFAST: {ALPHA: 4, BETA_INV: 8}
DATA: {NUM_FRAMES: 4, CROP_SIZE: 32, TEST_CROP_SIZE: 32}
TRAIN: {ENABLE: False}
TPU: {COMPUTE_DTYPE: float32}
"""


def test_export_int8_uses_persisted_calibration(tmp_path):
    """The CLI path (python -m efficient_slowfast_tpu_torch.tools.
    export_serving): a yaml, a .pyth of the weights and, under OUTPUT_DIR,
    the calibration the serving engines persisted for them; the export
    loads it (fingerprint-checked) with no quant= given."""
    from efficient_slowfast_tpu_torch.engine.state import create_train_state
    from efficient_slowfast_tpu_torch.utils.checkpoint import save_checkpoint

    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(_TINY_YAML)
    cfg = _int8(_tiny())
    cfg.OUTPUT_DIR = str(tmp_path)
    model = _model(cfg, seeded_variables(_tiny()))
    quantize.save_calibration(cfg, model, quantize.calibrate_int8(
        model, [_tensors(_inputs(cfg, 2))]))
    ckpt = save_checkpoint(str(tmp_path / "weights"), create_train_state(
        cfg, model, device="cpu"), 0, cfg)
    out = export_cli.main([
        "--cfg", str(yaml), "--out", str(tmp_path / "cli"), "--device",
        "cpu", "OUTPUT_DIR", str(tmp_path), "TPU.INT8_EVAL", "True",
        "TEST.CHECKPOINT_FILE_PATH", ckpt])
    serving = load_serving(out)
    assert _graph_ops(serving)["int8_conv"] > 0
    x = _inputs(cfg, 2, seed=3)
    np.testing.assert_allclose(
        serving(x), make_forward(cfg, model, device="cpu")(_tensors(x)).numpy(),
        rtol=1e-5, atol=1e-6)


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def test_kernel_op_flops_count_their_plain_versions(caplog):
    """get_flop_stats counts K1, K2 and K3 by formula as their plain
    versions' products count (fused engine against the module forward,
    FLASH_ATTENTION True against False, int8 against float), so the card and
    the CPU count the same; log_model_info logs the activations and, under
    TPU.LOG_FLOPS_PER_LAYER, the per-module table."""
    counts = {}
    for flash in (True, False):
        cfg = small_cfg(model="SlowFastDualAttention", depth=18, width=8,
                        flash_min_tokens=64)
        cfg.TPU.FLASH_ATTENTION = flash
        counts[flash] = misc.get_flop_stats(
            _model(cfg), pathway_inputs(cfg, 1, device="cpu"))
    assert counts[True] == counts[False] > 0
    cfg = small_cfg(fused=True, depth=18, width=8)
    model, x = _model(cfg), pathway_inputs(cfg, 1, device="cpu")
    fused = _Fn(make_fused_eval_forward(cfg, model.eval()))
    assert misc.get_flop_stats(fused, x) == misc.get_flop_stats(model, x)
    cfg.TPU.FUSED_EVAL = False
    cfg.TPU.INT8_EVAL = cfg.TPU.INT8_SPATIAL = True
    cfg.TPU.LOG_FLOPS_PER_LAYER = True
    int8 = _model(cfg)
    assert misc.get_flop_stats(int8, x) == misc.get_flop_stats(model, x)
    with caplog.at_level(logging.INFO):
        misc.log_model_info(int8, cfg, x)
    text = caplog.text
    assert "Activations:" in text and "GFLOPs" in text
    assert "SlowFast.s1.pathway0_stem.conv" in text
