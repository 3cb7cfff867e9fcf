"""Grad-CAM over one video clip: overlays per pathway as mp4 and GIF (port
of ``visualization/video_cam.py``; reference:
wdf_visualization/gradcam_video.py:59-402).

``gradcam_clip`` takes a decoded clip through the test preprocess, Grad-CAM
and the overlays; ``gradcam_video`` decodes the clip from a file first and
writes each pathway's overlays through the port's mp4 encoder, and with
``write_gif`` also as a GIF (PIL).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..data import decoder
from ..data.preprocess import make_test_preprocess
from ..models import build_model
from ..models.build import get_compute_dtype, resolve_device
from ..utils.checkpoint import load_test_checkpoint
from ..utils.logging import get_logger
from .gradcam import GradCAM, overlay_heatmap

logger = get_logger(__name__)


def _denormalize(pathway: np.ndarray, mean, std) -> np.ndarray:
    """DATA.MEAN/STD normalization reverted to uint8 frames."""
    video = np.asarray(pathway) * np.asarray(std) + np.asarray(mean)
    return (np.clip(video, 0.0, 1.0) * 255).astype(np.uint8)


def gradcam_clip(cfg, model: torch.nn.Module, clip: np.ndarray,
                 target_layer: str, target_class: Optional[int] = None) -> dict:
    """Grad-CAM of one uint8 clip (T, H, W, 3) at ``target_layer`` for
    ``target_class`` (the top class where None), on the model's device:
    the clip's centre crop through the test preprocess in the compute
    dtype, then the CAMs and each pathway's overlays. Returns
    {"predictions": (1, C), "cams": one (1, T', H', W') a pathway,
    "overlays": uint8 (T_p, S, S, 3) a pathway, "fps": a pathway's
    playback rate}."""
    device = next(model.parameters()).device
    preprocess = make_test_preprocess(cfg, get_compute_dtype(cfg))
    inputs = preprocess(
        torch.from_numpy(np.array(clip))[None].to(device),
        torch.tensor([clip.shape[2]], dtype=torch.int32, device=device),
        torch.tensor([1], dtype=torch.int32, device=device))  # centre crop
    class_idx = None if target_class is None else np.asarray(
        [int(target_class)])
    preds, cams = GradCAM(model, target_layer, cfg)(inputs, class_idx)
    shown = int(np.argmax(preds[0])) if target_class is None else int(
        target_class)
    logger.info("Grad-CAM class %d (score %.4f) at layer '%s'",
                shown, float(preds[0, shown]), target_layer)
    # a stage target gives a CAM per pathway; a single-tensor target (one
    # block) gives one, laid over every pathway's clip (overlay_heatmap
    # resizes the CAM's grid to each clip's)
    if not isinstance(cams, list):
        cams = [cams] * len(inputs)
    # the clip's NUM_FRAMES fast frames span NUM_FRAMES · SAMPLING_RATE
    # source frames at TARGET_FPS; a pathway with fewer frames spans the
    # same time, so its rate scales with its frame count
    fast_fps = cfg.DATA.TARGET_FPS / max(cfg.DATA.SAMPLING_RATE, 1)
    overlays, fps = [], []
    for pathway, cam in zip(inputs, cams):
        frames = _denormalize(pathway[0].float().cpu().numpy(),
                              cfg.DATA.MEAN, cfg.DATA.STD)
        overlays.append(overlay_heatmap(frames, cam[0]))
        fps.append(max(1, round(fast_fps * frames.shape[0]
                                / cfg.DATA.NUM_FRAMES)))
    return {"predictions": preds, "cams": cams, "overlays": overlays,
            "fps": fps}


def save_gif(path: str, frames: np.ndarray, fps: int) -> str:
    """uint8 (T, H, W, 3) frames as a looping GIF at ``fps``."""
    from PIL import Image

    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=0)
    return path


def gradcam_video(cfg, video_path: str, target_layer: str,
                  target_class: Optional[int] = None,
                  out_dir: Optional[str] = None, write_gif: bool = False,
                  device=None) -> dict:
    """Grad-CAM of ``video_path``'s first clip with ``cfg``'s model
    (seeded by RNG_SEED, then its test checkpoint) on ``device`` (the GPU
    by default), one overlay mp4 per pathway (and GIF with ``write_gif``)
    in ``out_dir`` (OUTPUT_DIR by default). ``target_layer``: see
    ``GradCAM`` (the reference offers s4, s5 and the fusions,
    gradcam_video.py:31-36). Returns {"predictions": (1, C), "outputs":
    the files written}."""
    out_dir = out_dir or cfg.OUTPUT_DIR or "."
    os.makedirs(out_dir, exist_ok=True)
    dev = resolve_device(device)
    torch.manual_seed(cfg.RNG_SEED)
    model = build_model(cfg, dev)
    load_test_checkpoint(cfg, model)

    clip = decoder.decode_clip(
        video_path, cfg.DATA.NUM_FRAMES, cfg.DATA.SAMPLING_RATE, 0, 1,
        cfg.DATA.TARGET_FPS, cfg.DATA.TEST_CROP_SIZE, False)
    if clip is None:
        raise RuntimeError(f"cannot decode {video_path}")
    result = gradcam_clip(cfg, model, clip, target_layer, target_class)

    stem = os.path.splitext(os.path.basename(video_path))[0]
    safe_layer = target_layer.replace("/", "_")
    outputs = []
    for p, (overlay, fps) in enumerate(zip(result["overlays"],
                                           result["fps"])):
        path = os.path.join(
            out_dir, f"gradcam_{stem}_{safe_layer}_pathway{p}.mp4")
        with decoder.VideoEncoder(path, overlay.shape[2], overlay.shape[1],
                                  fps) as enc:
            enc.append(overlay)
        outputs.append(path)
        if write_gif:
            outputs.append(save_gif(path[:-4] + ".gif", overlay, fps))
    logger.info("Wrote %s", ", ".join(outputs))
    return {"predictions": result["predictions"], "outputs": outputs}
