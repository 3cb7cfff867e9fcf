"""The port's detection demo (``engine/demo.py``, DETECTION.ENABLE) against
the JAX package's on one checkpoint, f32 on the CPU: the AVA SlowFast of
``configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml`` cut to R18 with basic blocks
at width 8, 8 frames, the 64-pixel crop and 5 classes (as
tests/test_ava.py::tiny_detection_cfg cuts it), from one ``.pyth`` that the
JAX package's ``export_torch_state_dict`` wrote. Each window's boxes on the
canvas and top classes are JAX's and its scores within 1e-4: boxes from a
DEMO.BOXES_FILE over a portrait video (two boxes in one window, none in
another), and a live DEMO.DETECTOR_FN detector over a camera-form stream.
The detector's three forms and their validation, function against
function."""

import json
import sys

import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.data import decoder as jax_decoder
from efficient_slowfast_tpu.engine import demo as jax_demo
from efficient_slowfast_tpu.utils.torch_ckpt import export_torch_state_dict
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.data import decoder
from efficient_slowfast_tpu_torch.engine import demo as port_demo
from torch_port_helpers import seeded_variables

AVA = "configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml"
TOL = 1e-4
CUTS = {"DATA.NUM_FRAMES": 8, "DATA.SAMPLING_RATE": 2,
        "DATA.TEST_CROP_SIZE": 64, "DATA.CROP_SIZE": 64,
        "MODEL.NUM_CLASSES": 5, "TPU.COMPUTE_DTYPE": "float32",
        "RESNET.DEPTH": 18, "RESNET.TRANS_FUNC": "basic_transform",
        "RESNET.WIDTH_PER_GROUP": 8,
        "RESNET.NUM_BLOCK_TEMP_KERNEL": [[2, 2]] * 4,
        "TRAIN.ENABLE": False, "TEST.ENABLE": False, "DEMO.ENABLE": True}

DETECTOR_PLUGIN = '''
import numpy as np

CALLS = []


def window_detector(frames, widx):
    """Per-window function form: boxes over the raw frames."""
    CALLS.append((widx, frames.shape))
    return np.asarray([[0.1, 0.1, 0.6, 0.9]], np.float32)


class CfgDetector:
    """Class form: instantiated once as cls(cfg)."""

    def __init__(self, cfg):
        self.crop = cfg.DATA.TEST_CROP_SIZE

    def __call__(self, frames, widx):
        return np.asarray([[0.2, 0.2, 0.8, 0.8]], np.float32)


def make_detector(cfg):
    """Factory form: make(cfg) -> per-window callable."""
    def fn(frames, widx):
        # out-of-range coordinates on purpose: the loader clips to [0, 1]
        return np.asarray([[-0.5, 0.0, 1.5, 2.0]], np.float32)
    return fn


def bad_shape_detector(frames, widx):
    return np.asarray([0.1, 0.1, 0.6], np.float32)
'''


def det_cfg(get, **opts):
    cfg = get()
    cfg.merge_from_file(AVA)
    for key, value in {**CUTS, **opts}.items():
        node = cfg
        *path, last = key.split(".")
        for part in path:
            node = node[part]
        node[last] = value
    return cfg


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "model.pyth"
    variables = seeded_variables(det_cfg(get_cfg))
    sd = export_torch_state_dict(variables["params"],
                                 variables["batch_stats"])
    torch.save({"model_state": {k: torch.from_numpy(np.array(v))
                                for k, v in sd.items()}}, path)
    return path


@pytest.fixture(scope="module")
def plugin(tmp_path_factory):
    """The detector plugin module on sys.path (its CALLS emptied per use)."""
    root = tmp_path_factory.mktemp("plugin")
    (root / "demo_det_plugin_port.py").write_text(DETECTOR_PLUGIN)
    sys.path.insert(0, str(root))
    import demo_det_plugin_port

    yield demo_det_plugin_port
    sys.path.remove(str(root))
    sys.modules.pop("demo_det_plugin_port", None)


def both(ckpt, out, stream=None, **opts):
    """{"jax": entries, "port": entries} of the two demos on one config."""
    runs = {}
    for name, get, module, device in (
            ("jax", jax_get_cfg, jax_demo, {}),
            ("port", get_cfg, port_demo, {"device": "cpu"})):
        cfg = det_cfg(get, **{"TEST.CHECKPOINT_FILE_PATH": str(ckpt),
                              "TEST.CHECKPOINT_TYPE": "pytorch",
                              "OUTPUT_DIR": str(out / name),
                              "DEMO.OUTPUT_FILE": str(out / f"{name}.mp4"),
                              **opts})
        runs[name] = module.demo(cfg, stream=None if stream is None
                                 else iter(stream), **device)
        runs[f"{name}_cfg"] = cfg
    return runs


def boxes_match(ours, theirs):
    assert [e["window"] for e in ours] == [e["window"] for e in theirs]
    for a, b in zip(ours, theirs):
        assert a["sec"] == b["sec"]
        assert len(a["boxes"]) == len(b["boxes"]) >= 1
        for x, y in zip(a["boxes"], b["boxes"]):
            assert x["box"] == y["box"]
            assert x["top_classes"] == y["top_classes"], (x, y)
            np.testing.assert_allclose(x["scores"], y["scores"], rtol=0,
                                       atol=TOL)
            # the RoI head's scores are per-box sigmoids
            assert all(0.0 <= s <= 1.0 for s in x["scores"])


@pytest.fixture(scope="module")
def portrait_runs(ckpt, tmp_path_factory):
    """A 160x96 portrait video of 96 frames at 24 fps (five windows): one
    box in window 0, two in window 1, none after."""
    tmp = tmp_path_factory.mktemp("portrait")
    src = str(tmp / "vert.mp4")
    decoder.write_test_video(src, np.random.RandomState(2).randint(
        0, 255, (96, 160, 96, 3), np.uint8), fps=24)
    boxes = tmp / "boxes.json"
    boxes.write_text(json.dumps({"0": [[0.2, 0.4, 0.8, 0.6]],
                                 "1": [[0.1, 0.1, 0.5, 0.9],
                                       [0.5, 0.2, 0.9, 0.8]]}))
    return both(ckpt, tmp, **{"DEMO.DATA_SOURCE": src,
                              "DEMO.BOXES_FILE": str(boxes)})


def test_boxes_file_demo_matches_jax(portrait_runs):
    ours = portrait_runs["port"]
    boxes_match(ours, portrait_runs["jax"])
    assert [len(e["boxes"]) for e in ours] == [1, 2]


def test_portrait_boxes_map_onto_the_canvas(portrait_runs):
    """The normalized boxes map through fit_canvas's resize and centre
    crop: width 64, height ~107 cropped to 64 from row 21, so y 0.4 and 0.6
    land near 21.7 and 43.1."""
    x1, y1, x2, y2 = portrait_runs["port"][0]["boxes"][0]["box"]
    assert 0 <= x1 < x2 <= 64
    assert 15 < y1 < 28 and 38 < y2 < 50, (y1, y2)
    # every window reaches the output video, the boxless ones too
    cfg = portrait_runs["port_cfg"]
    info = jax_decoder.probe(cfg.DEMO.OUTPUT_FILE)
    windows = list(port_demo.file_window_stream(cfg))
    assert len(windows) > 2
    assert info["nb_frames"] == len(windows) * cfg.DATA.NUM_FRAMES


def test_live_detector_on_a_camera_stream_matches_jax(ckpt, plugin,
                                                      tmp_path):
    """DEMO.DETECTOR_FN drives the detection demo on a camera-form source,
    which a boxes file cannot serve: the detector sees the raw window
    frames, once a window, and its boxes take the canvas mapping."""
    rs = np.random.RandomState(5)
    stream = [(w, rs.randint(0, 255, (8, 96, 128, 3), np.uint8))
              for w in range(2)]
    plugin.CALLS.clear()
    runs = both(ckpt, tmp_path, stream,
                **{"DEMO.DATA_SOURCE": "0",
                   "DEMO.DETECTOR_FN": "demo_det_plugin_port:window_detector"})
    # JAX's demo, then the port's, each once a window with the raw frames
    assert plugin.CALLS == [(0, (8, 96, 128, 3)), (1, (8, 96, 128, 3))] * 2
    boxes_match(runs["port"], runs["jax"])
    assert [len(e["boxes"]) for e in runs["port"]] == [1, 1]
    info = jax_decoder.probe(runs["port_cfg"].DEMO.OUTPUT_FILE)
    assert info["nb_frames"] == 2 * 8


def test_boxes_file_on_a_camera_source_raises(ckpt, tmp_path):
    cfg = det_cfg(get_cfg, **{"DEMO.DATA_SOURCE": "0",
                              "DEMO.BOXES_FILE": str(tmp_path / "b.json"),
                              "OUTPUT_DIR": str(tmp_path)})
    (tmp_path / "b.json").write_text("{}")
    with pytest.raises(AssertionError, match="DEMO.DETECTOR_FN"):
        port_demo.demo(cfg, device="cpu")


def test_load_detector_forms_and_validation(plugin):
    """The three symbol forms (function, class(cfg), factory(cfg)) give
    JAX's boxes, clipped to [0, 1]; bad shapes and names raise as JAX's."""
    frames = np.zeros((4, 32, 48, 3), np.uint8)
    for symbol, want in (("window_detector", [[0.1, 0.1, 0.6, 0.9]]),
                         ("CfgDetector", [[0.2, 0.2, 0.8, 0.8]]),
                         ("make_detector", [[0.0, 0.0, 1.0, 1.0]])):
        got = []
        for get, module in ((get_cfg, port_demo), (jax_get_cfg, jax_demo)):
            cfg = get()
            cfg.DEMO.DETECTOR_FN = f"demo_det_plugin_port:{symbol}"
            got.append(module._load_detector(cfg)(frames, 0))
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_allclose(got[0], want)
    cfg = get_cfg()
    for spec, error, match in (
            ("demo_det_plugin_port:bad_shape_detector", ValueError,
             "expected \\(N, 4\\)"),
            ("no_such_module:fn", RuntimeError, "cannot import"),
            ("justamodule", ValueError, "package.module:symbol")):
        cfg.DEMO.DETECTOR_FN = spec
        with pytest.raises(error, match=match):
            port_demo._load_detector(cfg)(frames, 0)
