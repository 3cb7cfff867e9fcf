"""The port's classification demo (``engine/demo.py::demo``) against the JAX
package's on one checkpoint, f32 on the CPU: a ``.pyth`` written from the
JAX variables by the JAX package's ``export_torch_state_dict`` and set as
TEST.CHECKPOINT_FILE_PATH for both, at the tiny shapes of
``configs/Synthetic/SHUFFLENETV2_TINY.yaml``. Each run's windows, ``sec``
and ``top_classes`` are JAX's and its scores within 1e-4: over a video file
(landscape, labels, the annotated mp4 and a display sink), and int8 over an
injected stream (one lazy calibration on the first window, then a run that
loads the persisted file). The port alone: the display's Esc and the
CLI's demo branch. JAX's ``demo()`` compiles its forward on each call, so
it runs twice here, through module-scoped fixtures."""

import importlib
import os

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
from efficient_slowfast_tpu_torch.engine import quantize
from efficient_slowfast_tpu_torch.tools import run_net
from torch_port_helpers import efficient_variables

TINY = "configs/Synthetic/SHUFFLENETV2_TINY.yaml"
TOL = 1e-4
jax_quantize = importlib.import_module("efficient_slowfast_tpu.engine.quantize")


def demo_opts(ckpt, out_dir, source="0", output="", labels=""):
    return ["TRAIN.ENABLE", False, "TEST.ENABLE", False, "DEMO.ENABLE", True,
            "TEST.CHECKPOINT_FILE_PATH", str(ckpt),
            "TEST.CHECKPOINT_TYPE", "pytorch", "DEMO.DATA_SOURCE", source,
            "DEMO.OUTPUT_FILE", output, "DEMO.LABEL_FILE_PATH", labels,
            "OUTPUT_DIR", str(out_dir)]


def demo_cfg(get, *opts):
    cfg = get()
    cfg.merge_from_file(TINY)
    for key, value in zip(opts[0::2], opts[1::2]):
        node = cfg
        *path, last = key.split(".")
        for part in path:
            node = node[part]
        node[last] = value
    return cfg


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The checkpoint both packages load: the port's seeded init (BN
    statistics jittered, attention γ and biases seeded) through the bridge,
    exported by the JAX package."""
    path = tmp_path_factory.mktemp("weights") / "model.pyth"
    variables = efficient_variables(demo_cfg(get_cfg))
    sd = export_torch_state_dict(variables["params"],
                                 variables["batch_stats"],
                                 demo_cfg(jax_get_cfg))
    torch.save({"model_state": {k: torch.from_numpy(np.array(v))
                                for k, v in sd.items()}}, path)
    return path


def entries_match(ours, theirs):
    assert len(ours) == len(theirs) >= 2
    for a, b in zip(ours, theirs):
        assert a["_type"] == b["_type"] == "demo_window"
        assert (a["window"], a["sec"]) == (b["window"], b["sec"])
        assert a["top_classes"] == b["top_classes"], (a, b)
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=0,
                                   atol=TOL)
        assert a["fps"] > 0


@pytest.fixture(scope="module")
def file_runs(ckpt, tmp_path_factory):
    """Both demos over one landscape video with a labels file, the
    annotated mp4 and a display sink that records each window."""
    tmp = tmp_path_factory.mktemp("file")
    src = str(tmp / "clip.mp4")
    n, h, w = 96, 96, 128
    frames = np.random.RandomState(11).randint(0, 255, (n, h, w, 3), np.uint8)
    frames[:, :, :, 1] = np.arange(n, dtype=np.uint8)[:, None, None] * 2
    decoder.write_test_video(src, frames, fps=24)
    labels = tmp / "labels.csv"
    labels.write_text("id,name\n" + "".join(f"{i},class{i}\n"
                                            for i in range(10)))
    runs = {}
    for name, get, module, device in (
            ("jax", jax_get_cfg, jax_demo, {}),
            ("port", get_cfg, port_demo, {"device": "cpu"})):
        shown = []
        cfg = demo_cfg(get, *demo_opts(ckpt, tmp / name, src,
                                       str(tmp / f"{name}.mp4"), str(labels)))
        results = module.demo(cfg, display=lambda f: shown.append(f) or True,
                              **device)
        runs[name] = dict(results=results, shown=shown, cfg=cfg)
    return runs


def test_file_demo_windows_match_jax(file_runs):
    ours, theirs = file_runs["port"]["results"], file_runs["jax"]["results"]
    entries_match(ours, theirs)
    assert [e["window"] for e in ours] == list(range(len(ours)))
    for entry in ours:  # names from LABEL_FILE_PATH, not raw ids
        assert all(c.startswith("class") for c in entry["top_classes"])


def test_file_demo_shows_and_writes_the_annotated_windows(file_runs):
    cfg = file_runs["port"]["cfg"]
    shown = file_runs["port"]["shown"]
    results = file_runs["port"]["results"]
    windows = list(port_demo.file_window_stream(cfg))
    assert len(shown) == len(results) == len(windows)
    # each shown window is its window annotated, JAX's overlay byte for byte
    for s, (_, window), entry in zip(shown, windows, results):
        assert s.shape == window.shape and s.dtype == np.uint8
        assert np.array_equal(s, jax_demo._annotate(window, entry))
    for run in ("port", "jax"):
        info = jax_decoder.probe(file_runs[run]["cfg"].DEMO.OUTPUT_FILE)
        assert info["nb_frames"] == len(results) * cfg.DATA.NUM_FRAMES
        # playback at the window's frame rate: TARGET_FPS / SAMPLING_RATE
        assert round(info["fps"]) == round(
            cfg.DATA.TARGET_FPS / cfg.DATA.SAMPLING_RATE)


def stream_windows(cfg, count, seed):
    short = cfg.DATA.TEST_CROP_SIZE
    rs = np.random.RandomState(seed)
    return [(w, rs.randint(0, 255, (cfg.DATA.NUM_FRAMES, short,
                                    short * 4 // 3, 3), np.uint8))
            for w in range(count)]


@pytest.fixture(scope="module")
def int8_runs(ckpt, tmp_path_factory):
    """TPU.INT8_EVAL over an injected camera-form stream of 3 windows: JAX
    once, the port twice in one OUTPUT_DIR (the second loads the
    calibration the first persisted); the calibrations each counted."""
    tmp = tmp_path_factory.mktemp("int8")
    out = {}
    for name, get, module, qmod, device, times in (
            ("jax", jax_get_cfg, jax_demo, jax_quantize, {}, 1),
            ("port", get_cfg, port_demo, quantize, {"device": "cpu"}, 2)):
        cfg = demo_cfg(get, *demo_opts(ckpt, tmp / name),
                       "TPU.INT8_EVAL", True)
        real, calls = qmod.calibrate_int8, []
        qmod.calibrate_int8 = lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            for i in range(times):
                results = module.demo(cfg, stream=iter(stream_windows(
                    cfg, 3, 3)), **device)
                out[f"{name}{i}"] = (results, len(calls))
        finally:
            qmod.calibrate_int8 = real
        out[f"{name}_cfg"] = cfg
    return out


def test_int8_demo_calibrates_once_and_matches_jax(int8_runs):
    ours, calls = int8_runs["port0"]
    theirs, jax_calls = int8_runs["jax0"]
    assert calls == jax_calls == 1  # on the first window only
    assert len(ours) == 3
    entries_match(ours, theirs)
    for entry in ours:
        assert all(np.isfinite(s) for s in entry["scores"])
    assert os.path.exists(quantize.calibration_path(int8_runs["port_cfg"]))


def test_int8_demo_loads_the_persisted_calibration(int8_runs):
    first, _ = int8_runs["port0"]
    again, calls = int8_runs["port1"]
    assert calls == 1  # the first run's: none in the second
    for a, b in zip(first, again):
        assert (a["window"], a["top_classes"], a["scores"]) == \
            (b["window"], b["top_classes"], b["scores"])


def test_display_sink_and_esc_quit(ckpt, tmp_path):
    """Each window's annotated frames reach the sink; the sink returning
    False (Esc) stops the demo after that window."""
    cfg = demo_cfg(get_cfg, *demo_opts(ckpt, tmp_path))
    shown = []

    def show(frames):
        shown.append(frames.shape)
        return len(shown) < 2  # Esc during the second window

    results = port_demo.demo(cfg, stream=iter(stream_windows(cfg, 4, 4)),
                             display=show, device="cpu")
    assert len(shown) == 2 and len(results) == 2
    assert all(s[0] == cfg.DATA.NUM_FRAMES and s[-1] == 3 for s in shown)


def test_the_cli_runs_the_demo(file_runs, ckpt, tmp_path):
    """run_net's demo branch: the file run's windows and scores; with no
    GPU and no --device it raises."""
    src = file_runs["port"]["cfg"].DEMO.DATA_SOURCE
    argv = ["--cfg", TINY] + [str(v) for v in demo_opts(ckpt, tmp_path, src)]
    out = run_net.main(["--device", "cpu"] + argv)
    assert set(out) == {"demo"}
    want = file_runs["port"]["results"]
    got = [(e["window"], e["scores"]) for e in out["demo"]]
    assert got == [(e["window"], e["scores"]) for e in want]
    # no labels file here: raw class ids, the file run's classes
    assert [e["top_classes"] for e in out["demo"]] == [
        [int(c[len("class"):]) for c in e["top_classes"]] for e in want]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_net.main(argv)
