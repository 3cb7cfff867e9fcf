"""Host-side (PIL/numpy) clip transform classes (port of
``data/host_transforms.py``; reference: slowfast/datasets/transform.py
:24-282, the PIL-based Compose/Scale/RandomRotate/RandomResize/
Gaussian_blur/SaltImage/Temporal*Crop classes of the frame-folder
wheel/tired/smoke pipelines).

All operate on uint8 numpy clips (T, H, W, C) and compose with ``Compose``.
Each is called as ``t(clip, rng)``: the random ones draw from the caller's
``np.random.Generator`` (the JAX package draws the same quantities from
the global ``random`` and ``np.random``), the others ignore it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np


def _resize(clip: np.ndarray, nh: int, nw: int) -> np.ndarray:
    from PIL import Image

    out = np.empty((clip.shape[0], nh, nw, clip.shape[3]), np.uint8)
    for i in range(clip.shape[0]):
        out[i] = np.asarray(
            Image.fromarray(clip[i]).resize((nw, nh), Image.BILINEAR))
    return out


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, clip: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        for t in self.transforms:
            clip = t(clip, rng)
        return clip


class Scale:
    """Resize the short side to `size` (bilinear), preserving aspect."""

    def __init__(self, size: int):
        self.size = int(size)

    def __call__(self, clip: np.ndarray, rng=None) -> np.ndarray:
        _, h, w, _ = clip.shape
        if min(h, w) == self.size:
            return clip
        if h < w:
            return _resize(clip, self.size, int(round(w * self.size / h)))
        return _resize(clip, int(round(h * self.size / w)), self.size)


class RandomResize:
    """Random uniform rescale within [ratio_min, ratio_max]."""

    def __init__(self, ratio=(3.0 / 4.0, 4.0 / 3.0)):
        self.ratio = ratio

    def __call__(self, clip: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        scale = rng.uniform(*self.ratio)
        _, h, w, _ = clip.shape
        return _resize(clip, int(round(h * scale)), int(round(w * scale)))


class RandomRotate:
    """Random rotation within ±degrees (expand=False, like PIL rotate)."""

    def __init__(self, degrees: float = 10.0):
        self.degrees = degrees

    def __call__(self, clip: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        from PIL import Image

        angle = rng.uniform(-self.degrees, self.degrees)
        out = np.empty_like(clip)
        for i in range(clip.shape[0]):
            out[i] = np.asarray(
                Image.fromarray(clip[i]).rotate(angle, Image.BILINEAR))
        return out


class GaussianBlur:
    def __init__(self, radius: float = 1.0, prob: float = 0.5):
        self.radius = radius
        self.prob = prob

    def __call__(self, clip: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        from PIL import Image, ImageFilter

        if rng.random() >= self.prob:
            return clip
        out = np.empty_like(clip)
        f = ImageFilter.GaussianBlur(radius=self.radius)
        for i in range(clip.shape[0]):
            out[i] = np.asarray(Image.fromarray(clip[i]).filter(f))
        return out


class SaltImage:
    """Salt noise: random pixels set to white (reference SaltImage)."""

    def __init__(self, ratio: int = 100, prob: float = 0.5):
        self.ratio = ratio
        self.prob = prob

    def __call__(self, clip: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        if rng.random() >= self.prob:
            return clip
        out = clip.copy()
        noise = rng.integers(0, self.ratio, clip.shape[:3])
        out[noise == 0] = 255
        return out


class TemporalCenterCrop:
    """Keep the middle `size` frames (pad by edge repeat when short)."""

    def __init__(self, size: int):
        self.size = int(size)

    def __call__(self, clip: np.ndarray, rng=None) -> np.ndarray:
        t = clip.shape[0]
        if t >= self.size:
            start = (t - self.size) // 2
            return clip[start:start + self.size]
        idx = np.clip(np.arange(self.size) - (self.size - t) // 2, 0, t - 1)
        return clip[idx]


class TemporalRandomCrop:
    """Keep a random contiguous `size`-frame window."""

    def __init__(self, size: int):
        self.size = int(size)

    def __call__(self, clip: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        t = clip.shape[0]
        if t <= self.size:
            return TemporalCenterCrop(self.size)(clip)
        start = int(rng.integers(0, t - self.size, endpoint=True))
        return clip[start:start + self.size]


class TemporalBeginCrop:
    def __init__(self, size: int):
        self.size = int(size)

    def __call__(self, clip: np.ndarray, rng=None) -> np.ndarray:
        if clip.shape[0] >= self.size:
            return clip[: self.size]
        return TemporalCenterCrop(self.size)(clip)
