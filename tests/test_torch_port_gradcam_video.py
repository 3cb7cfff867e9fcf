"""The port's Grad-CAM video tool on a fixture video through
configs/Synthetic/SHUFFLENETV2_TINY.yaml: the files that JAX's
``gradcam_video`` writes from the same fixture and weights (one overlay
mp4 per pathway, GIFs with ``--gif``), with its frame counts per pathway
and playback rates, read back by both packages' decoders, and the rates
that tests/test_visualization.py:66-127 holds JAX's to."""

import importlib
import os
import types

import numpy as np
import torch

from efficient_slowfast_tpu.config import assert_and_infer_cfg
from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.data import decoder as jax_decoder
from efficient_slowfast_tpu.visualization import video_cam as jax_video_cam
from efficient_slowfast_tpu_torch.config import load_cfg
from efficient_slowfast_tpu_torch.data import decoder
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.tools import gradcam_video as tool
from efficient_slowfast_tpu_torch.utils.weights import \
    state_dict_to_jax_variables
from efficient_slowfast_tpu_torch.visualization.video_cam import gradcam_video

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "Synthetic", "SHUFFLENETV2_TINY.yaml")
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)


def _video(tmp_path, content):
    path = str(tmp_path / "clip.mp4")
    decoder.write_test_video(path, content, fps=30)
    return path


def _tiny(tmp_path):
    cfg = load_cfg(TINY)
    cfg.OUTPUT_DIR = str(tmp_path)
    return cfg


def _frames_and_fps(mp4s):
    """(frames, fps) of each mp4 by both packages' probes, which agree."""
    infos = [decoder.probe(p) for p in mp4s]
    assert infos == [jax_decoder.probe(p) for p in mp4s]
    return sorted((i["nb_frames"], round(i["fps"])) for i in infos)


def _gif_frames_and_ms(path):
    from PIL import Image

    with Image.open(path) as im:
        return im.n_frames, im.info["duration"]


def _jax_gradcam_video(monkeypatch, tmp_path, video, target, out_dir):
    """JAX's gradcam_video on the weights that the port's tool draws
    (torch.manual_seed(RNG_SEED), then build_model), carried across by the
    weight bridge: its create_train_state hands back those weights in
    place of its own init, which is the only part replaced."""
    cfg = jax_get_cfg()
    cfg.merge_from_file(TINY)
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg = assert_and_infer_cfg(cfg)
    torch.manual_seed(cfg.RNG_SEED)
    variables = state_dict_to_jax_variables(
        build_model(_tiny(tmp_path), device="cpu").state_dict(), cfg)
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    monkeypatch.setattr(importlib.import_module(
        "efficient_slowfast_tpu.engine.state"), "create_train_state",
        lambda *a, **k: (state, None))
    return jax_video_cam.gradcam_video(cfg, video, target, write_gif=True,
                                       out_dir=out_dir)


def test_gradcam_video_writes_what_jax_writes(tmp_path, monkeypatch):
    """A stage target on one fixture and the same weights: the port writes
    JAX's files (an mp4 and a GIF per pathway, by name), with JAX's frame
    counts and rates, and JAX's scores; the rates are those that
    tests/test_visualization.py holds JAX's to."""
    frames = np.zeros((48, 48, 64, 3), np.uint8)
    frames[:, :, :, 1] = np.arange(48, dtype=np.uint8)[:, None, None] * 3
    video = _video(tmp_path, frames)
    cfg = _tiny(tmp_path)
    out = str(tmp_path / "cam")
    result = gradcam_video(cfg, video, "s3", write_gif=True, out_dir=out,
                           device="cpu")
    assert result["predictions"].shape == (1, cfg.MODEL.NUM_CLASSES)
    assert result["outputs"] == [os.path.join(out, f"gradcam_clip_s3_pathway{p}"
                                              f".{ext}")
                                 for p in (0, 1) for ext in ("mp4", "gif")]
    assert all(os.path.getsize(p) > 0 for p in result["outputs"])
    jax_out = str(tmp_path / "jax_cam")
    want = _jax_gradcam_video(monkeypatch, tmp_path, video, "s3", jax_out)
    assert [os.path.relpath(p, out) for p in result["outputs"]] == [
        os.path.relpath(p, jax_out) for p in want["outputs"]]
    np.testing.assert_allclose(result["predictions"], want["predictions"],
                               **SCORE_TOL)
    assert _frames_and_fps(result["outputs"][::2]) == _frames_and_fps(
        want["outputs"][::2])
    assert [_gif_frames_and_ms(p) for p in result["outputs"][1::2]] == [
        _gif_frames_and_ms(p) for p in want["outputs"][1::2]]
    t_fast = cfg.DATA.NUM_FRAMES
    fast_fps = cfg.DATA.TARGET_FPS / cfg.DATA.SAMPLING_RATE
    assert _frames_and_fps(result["outputs"][::2]) == sorted([
        (t_fast // cfg.SLOWFAST.ALPHA, max(1, round(fast_fps
                                                    / cfg.SLOWFAST.ALPHA))),
        (t_fast, round(fast_fps))])


def test_gradcam_video_tool_at_a_jax_block_path(tmp_path, capsys):
    """The CLI at ``s3/pathway1_block0`` (one CAM, laid over both
    pathways' clips): the top five classes, then the two mp4s; and
    ``--print-flops``' per-layer table."""
    video = _video(tmp_path, np.full((48, 48, 64, 3), 90, np.uint8))
    out = str(tmp_path / "cam")
    tool.main(["--cfg", TINY, "--video", video, "--target-layer",
               "s3/pathway1_block0", "--out-dir", out, "--device", "cpu",
               "OUTPUT_DIR", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    mp4s = [os.path.join(out, f"gradcam_clip_s3_pathway1_block0_pathway{p}"
                              ".mp4") for p in (0, 1)]
    assert lines[-2:] == mp4s and len(lines) == 7
    cfg = _tiny(tmp_path)
    fast_fps = cfg.DATA.TARGET_FPS / cfg.DATA.SAMPLING_RATE
    assert _frames_and_fps(mp4s) == sorted([
        (2, max(1, round(fast_fps / 4))), (8, round(fast_fps))])
    table = tool.main(["--cfg", TINY, "--video", video, "--print-flops",
                       "--device", "cpu", "OUTPUT_DIR", str(tmp_path)])
    assert table.splitlines()[0].split() == ["module", "GFLOPs", "share"]
    assert any(line.startswith("SlowFastShuffleNetV2.s3 ")
               for line in table.splitlines())
