"""Preprocessing on the card: the stage between the loader and the model
(port of ``data/preprocess.py:27-145``).

Replaces the reference's per-worker CPU chain (reference:
slowfast/datasets/kinetics.py:122-255 __getitem__ → tensor_normalize →
spatial_sampling → pack_pathway_output) with torch ops on the batch's
device: crop-and-resize from each clip's box → normalize → portrait swap →
flip → pathway pack, in the compute dtype.

Host contract: the loader supplies
  frames: (B, T, S, Wc, 3) uint8 — short side exactly S, true content width
          widths[i] ≤ Wc (right-padded), already temporally sampled to T;
  widths, spatial_idx, portrait, crop_u: (B,) arrays, on the host.

The crop comes first and the normalization after it, on the crop: the
bilinear weights of each output pixel sum to 1 and the normalization is
affine per channel, so the order changes only float32 rounding, and the
64-clip test canvas is never expanded to float32 whole (3.2 GB). The JAX
package normalizes first (preprocess.py:135-137).
"""

from __future__ import annotations

import torch

from . import transform as T
from .pathways import pack_pathway_output


def _normalize_(x: torch.Tensor, mean, std, from_uint8: bool) -> torch.Tensor:
    """(x [/ 255] − mean) / std, in place (no float32 copy of the batch)."""
    if from_uint8:
        x.div_(255.0)
    return x.sub_(T._on(mean, x.device)).div_(T._on(std, x.device))


def make_train_preprocess(cfg, dtype=torch.float32, crop_size=None):
    """pre(generator, frames, widths, portrait=None, crop_u=None) →
    pathways in ``dtype``, channels-last and contiguous, cropped to
    ``crop_size`` (a short cycle's; ``DATA.TRAIN_CROP_SIZE`` by default).

    The draws (scale, position, flip, colour factors) come from
    ``generator``, on the device it lives on; one generator a step.
    """
    mean, std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
    min_s, max_s = cfg.DATA.TRAIN_JITTER_SCALES
    crop = int(crop_size) if crop_size else cfg.DATA.TRAIN_CROP_SIZE
    flip = cfg.DATA.RANDOM_FLIP
    inv = cfg.DATA.INV_UNIFORM_SAMPLE
    # Jester-style clip-level color jitter: [lo, hi] enhancement-factor range
    # (reference: datasets/decoder.py:447-454 applies it for jester train/val)
    jitter = tuple(cfg.DATA.TRAIN_COLOR_JITTER)

    def pre(generator, frames, widths, portrait=None, crop_u=None):
        b, _, h = frames.shape[:3]
        # crop_u: the host's long-axis position, shared with the canvas
        # window (datasets.fit_canvas_into window_u), so the composed crop
        # spans the full resized long axis on >2:1 media (reference
        # transform.py:359-392)
        boxes = T.random_scale_crop_boxes(
            generator, b, h, widths, min_s, max_s, crop, inverse_uniform=inv,
            u_x=crop_u)
        x = T.crop_and_resize(frames, boxes, crop)
        from_uint8 = frames.dtype == torch.uint8
        if jitter:
            mean_luma = T.content_mean_luma(frames, widths)
            if from_uint8:
                x, mean_luma = x.div_(255.0), mean_luma / 255.0
            x = T.pil_color_jitter(generator, x, jitter[0], jitter[1],
                                   mean_luma=mean_luma)
            from_uint8 = False
        x = _normalize_(x, mean, std, from_uint8)
        if portrait is not None:
            # restore tall clips' orientation BEFORE the flip so the flip
            # stays horizontal in content coordinates
            x = T.transpose_portrait(x, portrait)
        if flip:
            x = T.horizontal_flip(generator, x)
        return pack_pathway_output(cfg, x.to(dtype).contiguous())

    return pre


def make_detection_preprocess(cfg, dtype=torch.float32):
    """pre(frames) → pathways in ``dtype``: AVA serving normalizes and
    packs the whole canvas, with no crop, as its boxes are in canvas
    pixels."""
    mean, std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)

    def pre(frames):
        x = _normalize_(frames.to(torch.float32, copy=True), mean, std,
                        frames.dtype == torch.uint8)
        return pack_pathway_output(cfg, x.to(dtype).contiguous())

    return pre


def make_detection_train_preprocess(cfg, dtype=torch.float32):
    """pre(generator, frames, widths, boxes) → (pathways in ``dtype``,
    boxes in crop pixels): AVA's train augmentation with the boxes carried
    along (reference: ava_dataset._images_and_boxes_preprocessing_cv2,
    train branch): scale jitter and a random crop, the flip, colour jitter
    in a random order (``AVA.TRAIN_USE_COLOR_AUGMENTATION`` without
    ``AVA.TRAIN_PCA_JITTER_ONLY``), PCA lighting noise (with colour
    augmentation), then the normalization. The draws come from
    ``generator``."""
    mean, std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
    min_s, max_s = cfg.DATA.TRAIN_JITTER_SCALES
    crop = cfg.DATA.TRAIN_CROP_SIZE
    flip = cfg.DATA.RANDOM_FLIP
    use_color = cfg.AVA.TRAIN_USE_COLOR_AUGMENTATION
    pca_only = cfg.AVA.TRAIN_PCA_JITTER_ONLY
    eigval = tuple(cfg.AVA.TRAIN_PCA_EIGVAL)
    eigvec = tuple(tuple(r) for r in cfg.AVA.TRAIN_PCA_EIGVEC)

    def pre(generator, frames, widths, boxes):
        b, _, h = frames.shape[:3]
        crop_boxes = T.random_scale_crop_boxes(generator, b, h, widths,
                                               min_s, max_s, crop)
        x = T.crop_and_resize(frames, crop_boxes, crop)
        if frames.dtype == torch.uint8:
            x = x.div_(255.0)
        boxes = T.transform_boxes_to_crop(
            boxes.to(x.device, torch.float32, non_blocking=True),
            crop_boxes, crop)
        if flip:
            x, boxes = T.horizontal_flip_with_boxes(generator, x, boxes)
        if use_color:
            if not pca_only:
                x = T.color_jitter(generator, x, 0.4, 0.4, 0.4)
            x = T.lighting_jitter(generator, x, 0.1, eigval, eigvec)
        x = _normalize_(x, mean, std, False)
        return pack_pathway_output(cfg, x.to(dtype).contiguous()), boxes

    return pre


def make_test_preprocess(cfg, dtype=torch.float32):
    """pre(frames, widths, spatial_idx, portrait=None) → pathways in
    ``dtype``, channels-last and contiguous: the ``spatial_idx`` crop of
    each clip (left/top, centre, right/bottom)."""
    mean, std = tuple(cfg.DATA.MEAN), tuple(cfg.DATA.STD)
    crop = cfg.DATA.TEST_CROP_SIZE

    def pre(frames, widths, spatial_idx, portrait=None):
        h = frames.shape[2]
        boxes = T.uniform_crop_boxes(h, widths, crop, crop, spatial_idx)
        x = _normalize_(T.crop_and_resize(frames, boxes, crop), mean, std,
                        frames.dtype == torch.uint8)
        if portrait is not None:
            # tall clips ride the canvas transposed; the crop above was along
            # their original vertical axis (top/center/bottom views) — swap
            # the square crop back (reference: transform.py:425-468)
            x = T.transpose_portrait(x, portrait)
        return pack_pathway_output(cfg, x.to(dtype).contiguous())

    return pre
