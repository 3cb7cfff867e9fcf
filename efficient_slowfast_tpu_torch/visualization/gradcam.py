"""Grad-CAM for video models (port of ``visualization/gradcam.py``;
reference: wdf_visualization/gradcam_video.py:59-225).

A forward hook on the target module keeps its output A, and
``torch.autograd.grad`` takes d(score)/dA of the chosen class's score, so
CAM = ReLU(Σ_c mean_{T,H,W}(d score / dA_c) · A_c), scaled to [0, 1] per
clip. The model runs in eval mode with autograd on for the call only; on
the card its attention runs K2 forward and K2-bwd from the score back to
the target.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _cam(act: torch.Tensor, grad: torch.Tensor) -> np.ndarray:
    """The (B, T, H, W) CAM in [0, 1] of an NCDHW activation and its
    gradient, in float32."""
    act, grad = act.detach().float(), grad.float()
    weights = grad.mean(dim=(2, 3, 4), keepdim=True)  # (B, C, 1, 1, 1)
    cam = torch.relu((weights * act).sum(dim=1))  # over C: (B, T, H, W)
    cmin = cam.amin(dim=(1, 2, 3), keepdim=True)
    cmax = cam.amax(dim=(1, 2, 3), keepdim=True)
    return ((cam - cmin) / torch.clamp(cmax - cmin, min=1e-8)).cpu().numpy()


class GradCAM:
    """Grad-CAM heatmaps of ``target_layer`` of ``model``.

    ``target_layer`` is a module name of the port (``s4``, ``s4_fuse``,
    ``s4.pathway1_res3``, an efficient family's ``nn.Sequential`` index) or
    the JAX package's slash-joined module path (``s5/pathway0_res2``;
    ``s3/pathway1_block0`` of an efficient family, which needs ``cfg``).
    An unknown layer raises ``KeyError``."""

    def __init__(self, model: torch.nn.Module, target_layer: str, cfg=None):
        from ..utils.weights import jax_module_to_torch

        self.model = model
        modules = dict(model.named_modules())
        name = target_layer
        if name not in modules:
            name = jax_module_to_torch(target_layer, cfg)
        if not target_layer or name not in modules:
            raise KeyError(
                f"target layer '{target_layer}' not found; name a module of "
                "the model (e.g. 's5', 's4.pathway1_res3') or a slash-joined "
                "JAX module path (e.g. 's5/pathway0_res2')")
        self.target = name
        self.module = modules[name]

    def __call__(self, inputs, class_idx: Optional[np.ndarray] = None):
        """(scores (B, classes), CAMs) of the pathways ``inputs`` ((B, T,
        H, W, C) each) for ``class_idx`` (the top class where None): one
        CAM (B, T', H', W') for a module that gives one tensor, a list of
        one per pathway for a stage."""
        model = self.model.eval()
        device = next(model.parameters()).device
        inputs = [x.to(device) for x in inputs]
        seen = []
        hook = self.module.register_forward_hook(
            lambda mod, args, out: seen.append(out))
        try:
            with torch.enable_grad():
                preds = model(inputs)
                act = seen[-1]
                acts = list(act) if isinstance(act, (list, tuple)) else [act]
                idx = (preds.argmax(-1) if class_idx is None else
                       torch.as_tensor(np.asarray(class_idx), device=device))
                score = preds[torch.arange(preds.shape[0], device=device),
                              idx].sum()
                grads = torch.autograd.grad(score, acts)
        finally:
            hook.remove()
        cams = [_cam(a, g) for a, g in zip(acts, grads)]
        scores = preds.detach().float().cpu().numpy()
        return scores, (cams if isinstance(act, (list, tuple)) else cams[0])


def overlay_heatmap(frames: np.ndarray, cam: np.ndarray,
                    alpha: float = 0.5) -> np.ndarray:
    """``cam`` (T', h, w) in [0, 1] blended onto uint8 ``frames`` (T, H, W,
    3): each frame takes the nearest CAM frame, resized bilinearly (PIL) to
    the frame, through a jet-like colour map (reference:
    wdf_visualization/misc_functions.py)."""
    from PIL import Image

    t, h, w, _ = frames.shape
    tc = cam.shape[0]
    out = np.empty_like(frames)
    for i in range(t):
        ci = min(int(round(i * (tc - 1) / max(t - 1, 1))), tc - 1)
        heat = np.asarray(
            Image.fromarray((cam[ci] * 255).astype(np.uint8)).resize(
                (w, h), Image.BILINEAR),
            np.float32) / 255.0
        # red rises with the heat, blue falls, green peaks at the middle
        color = np.stack([
            heat * 255.0,
            np.maximum(0.0, 1.0 - np.abs(heat - 0.5) * 2) * 255.0,
            (1.0 - heat) * 255.0,
        ], axis=-1)
        out[i] = np.clip(
            (1 - alpha) * frames[i].astype(np.float32) + alpha * color, 0, 255
        ).astype(np.uint8)
    return out
