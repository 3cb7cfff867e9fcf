"""Batched video transforms on the frames' device (port of
``data/transform.py``; reference: slowfast/datasets/transform.py —
random_short_side_scale_jitter :283-337, random_crop :359-392,
horizontal_flip :395-422, uniform_crop :425-468; slowfast/datasets/utils.py
— tensor_normalize :298-317).

The reference's "resize the short side to a random scale, then crop a
fixed window" is one bilinear crop-and-resize from a source box per clip,
so every batch has one output shape whatever the scale drawn. Frames are
channels-last (B, T, H, W, C), uint8 or float. Random draws take a
``torch.Generator`` on the device they are drawn for. Small per-clip arrays
(widths, boxes, flags) may live on the host: they are copied to the frames'
device without a synchronisation. Across processes every per-clip draw
is this rank's rows of the draw for the global batch
(``parallel.distributed.global_rows``), so the ranks together draw what
one process draws.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.distributed import global_rows


def _rand(generator, shape, dim=0, normal=False):
    """Draws of ``shape`` from ``generator``, uniform in [0, 1) (normal
    with ``normal``), axis ``dim`` running over the clips of the batch."""
    fn = torch.randn if normal else torch.rand
    return global_rows(lambda s: fn(s, generator=generator,
                                    device=generator.device), shape, dim)


def _uniform(generator, shape, lo, hi, dim=0):
    return _rand(generator, shape, dim) * (hi - lo) + lo


def _on(x, device):
    """``x`` as a float32 tensor on ``device`` (no synchronisation)."""
    return torch.as_tensor(x).to(device, torch.float32, non_blocking=True)


def tensor_normalize(frames: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 → float, /255, −mean, /std (reference: utils.py:298-317)."""
    x = frames.float()
    if frames.dtype == torch.uint8:
        x = x / 255.0
    return color_normalization(x, mean, std)


def color_normalization(frames, mean, stddev):
    mean = _on(mean, frames.device)
    stddev = _on(stddev, frames.device)
    return (frames - mean) / stddev


def crop_and_resize(frames: torch.Tensor, boxes, out_size: int) -> torch.Tensor:
    """Bilinear sample an axis-aligned box from each clip.

    frames: (B, T, H, W, C) uint8 or float; boxes: (B, 4) [y0, x0, y1, x1]
    in source pixel coordinates (half-open: the box covers [y0, y1) like a
    crop of size y1-y0). Returns float32 (B, T, out, out, C) in the frames'
    units (uint8 frames give values in [0, 255]).

    Sample centres sit at box_start + (i + 0.5) * box_size / out - 0.5, as
    torch's ``interpolate(align_corners=False)`` places them: an integral
    box of the output's size is an exact crop. Each output pixel gathers
    its four source pixels (floor, clamped to the frame) and lerps rows,
    then columns, in float32, as the JAX package does; only those pixels
    are converted, so a uint8 canvas is never expanded to float whole.
    Boxes on the host with integral corners and the output's size (the
    test crops) take one gather of those pixels.
    """
    b, t, h, w, _ = frames.shape
    dev = frames.device
    bi = torch.arange(b, device=dev)[:, None, None, None]
    ti = torch.arange(t, device=dev)[None, :, None, None]
    host = torch.as_tensor(boxes)
    if host.device.type == "cpu" and _pixel_crop(host, out_size):
        # each sample centre lands on a pixel (up to float32 rounding of
        # the centres): one gather, no lerp
        start = host[:, :2].long()
        pix = torch.arange(out_size)
        yi = torch.clamp(start[:, :1] + pix, 0, h - 1).to(dev, non_blocking=True)
        xi = torch.clamp(start[:, 1:] + pix, 0, w - 1).to(dev, non_blocking=True)
        return frames[bi, ti, yi[:, None, :, None], xi[:, None, None, :]].float()
    boxes = _on(boxes, dev)
    idx = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) / out_size

    def sample_axis(start, stop):
        # (B, out) fractional source coordinates
        return start[:, None] + idx[None, :] * (stop - start)[:, None] - 0.5

    ys = sample_axis(boxes[:, 0], boxes[:, 2])
    xs = sample_axis(boxes[:, 1], boxes[:, 3])
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, None, :, None, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[:, None, None, :, None]
    y1 = torch.clamp(y0 + 1, 0, h - 1).long()[:, None, :, None]
    x1 = torch.clamp(x0 + 1, 0, w - 1).long()[:, None, None, :]
    y0 = y0.long()[:, None, :, None]
    x0 = x0.long()[:, None, None, :]

    def column(xi):
        # rows y0 and y1 lerped at the columns xi: (B, T, out, out, C)
        r0 = frames[bi, ti, y0, xi].float()
        return frames[bi, ti, y1, xi].float().sub_(r0).mul_(wy).add_(r0)

    left = column(x0)
    return column(x1).sub_(left).mul_(wx).add_(left)


def _pixel_crop(boxes: torch.Tensor, out_size: int) -> bool:
    """Whether every box has integral corners and the output's size."""
    return bool(torch.equal(boxes, torch.round(boxes))
                and ((boxes[:, 2:] - boxes[:, :2]) == out_size).all())


def random_scale_crop_boxes(
    generator: torch.Generator,
    batch: int,
    height: int,
    widths,
    min_scale: int,
    max_scale: int,
    crop_size: int,
    inverse_uniform: bool = False,
    u_x=None,
) -> torch.Tensor:
    """Per-clip boxes equivalent to scale jitter + random crop, on the
    generator's device.

    The reference resizes the short side to s ~ U[min_scale, max_scale] then
    random-crops ``crop_size`` (reference: transform.py:283-337 + :359-392).
    Equivalently a window of source size crop_size * (short / s) is cut at
    a uniform position and resized to ``crop_size``. ``widths`` gives each
    clip's true (unpadded) width; ``height`` is the canvas short side.

    ``u_x`` (per clip, in [0, 1]) replaces the drawn horizontal position
    with the host's: content wider than the 2:1 canvas is windowed on the
    host at ``round(u·(L−wc))`` (datasets.fit_canvas_into window_u) and
    the crop here lands at ``u·(wc−win)`` inside it, so the composed
    offset ``u·(L−win)`` is uniform over the full resized long axis.
    """
    dev = generator.device
    u = _rand(generator, (3, batch), dim=1)
    if inverse_uniform:
        inv = u[0] * (1.0 / min_scale - 1.0 / max_scale) + 1.0 / max_scale
        scale = 1.0 / inv
    else:
        scale = u[0] * float(max_scale - min_scale) + float(min_scale)
    widths = _on(widths, dev)
    short = torch.clamp(widths, max=float(height))
    win = crop_size * short / scale  # source window size (per clip)
    wmax_y = float(height) - win
    wmax_x = widths - win
    oy = u[1] * torch.clamp(wmax_y, min=0.0)
    fx = u[2] if u_x is None else _on(u_x, dev)
    ox = fx * torch.clamp(wmax_x, min=0.0)
    return torch.stack([oy, ox, oy + win, ox + win], dim=1)


def uniform_crop_boxes(height: int, widths, scale: int, crop_size: int,
                       spatial_idx) -> torch.Tensor:
    """Deterministic 3-position test crops (reference: transform.py:425-468),
    on the device of ``widths``.

    Short side is resized to ``scale``, then a ``crop_size`` window is taken
    at position spatial_idx ∈ {0: left/top, 1: center, 2: right/bottom}.
    Expressed as source boxes of size crop_size * short / scale.
    """
    widths = torch.as_tensor(widths).float()
    short = torch.clamp(widths, max=float(height))
    win = crop_size * short / float(scale)
    max_y = float(height) - win
    max_x = widths - win
    # centered offsets use ceil like the reference (int(math.ceil((w-size)/2)),
    # transform.py:447-448) so integer-sized crops land on the exact pixels
    sidx = torch.as_tensor(spatial_idx).to(widths.device).float()

    def pos(max_off):  # 0 → 0, 1 → ceil(max/2), 2 → max
        return torch.where(sidx == 0, torch.zeros_like(max_off),
                           torch.where(sidx == 1.0, torch.ceil(max_off / 2.0),
                                       max_off))

    # wider-than-tall: offset along x; taller-than-wide: along y (portrait
    # canvases are stored transposed, datasets.fit_canvas_into, so in
    # practice the x axis is the crop axis)
    is_wide = widths >= height
    oy = torch.where(is_wide, torch.ceil(max_y / 2.0), pos(max_y))
    ox = torch.where(is_wide, pos(max_x), torch.ceil(max_x / 2.0))
    return torch.stack([oy, ox, oy + win, ox + win], dim=1)


def transpose_portrait(frames: torch.Tensor, portrait) -> torch.Tensor:
    """Swap H↔W of the square crops of clips flagged as transposed portrait
    storage.

    ``frames`` (B, T, S, S, C); ``portrait`` (B,) {0, 1} on the host. Tall
    clips ride the canvas axis-swapped (datasets.fit_canvas_into
    keep_portrait) so that the crop along canvas x covers their vertical
    axis; this restores their orientation after the crop. A batch with no
    such clip is returned as it is.
    """
    flag = torch.as_tensor(portrait).bool()
    if not bool(flag.any()):
        return frames
    flag = flag.to(frames.device, non_blocking=True)[:, None, None, None, None]
    return torch.where(flag, frames.transpose(2, 3), frames)


def horizontal_flip(generator, frames: torch.Tensor, prob: float = 0.5):
    """Per-clip random horizontal flip (reference: transform.py:395-422)."""
    do = _rand(generator, (frames.shape[0],)) < prob
    do = do.to(frames.device)[:, None, None, None, None]
    return torch.where(do, frames.flip(3), frames)


_LUMA = (0.299, 0.587, 0.114)  # ITU-R 601-2, PIL convert("L") weights


def luma(frames: torch.Tensor) -> torch.Tensor:
    """Per-pixel luma (..., 1) of channels-last RGB frames, in float32."""
    w = _LUMA
    return (frames[..., 0:1].float() * w[0] + frames[..., 1:2].float() * w[1]
            + frames[..., 2:3].float() * w[2])


def content_mean_luma(frames: torch.Tensor, widths) -> torch.Tensor:
    """Per-clip mean luma (B, 1, 1, 1, 1) over the unpadded content
    (columns below ``widths``) of (B, T, H, W, C) frames."""
    y = luma(frames)
    if widths is None:
        return y.mean(dim=(1, 2, 3), keepdim=True)
    wmask = (torch.arange(frames.shape[3], device=frames.device)[None, :]
             < _on(widths, frames.device)[:, None]).float()
    wmask = wmask[:, None, None, :, None]
    return ((y * wmask).sum(dim=(1, 2, 3), keepdim=True)
            / torch.clamp(wmask.sum(dim=(1, 2, 3), keepdim=True)
                          * frames.shape[1] * frames.shape[2], min=1.0))


def pil_color_jitter(generator, frames, lo=0.4, hi=1.4, widths=None,
                     mean_luma: Optional[torch.Tensor] = None):
    """Jester-style clip-level color jitter (reference: decoder.py:447-454 +
    transform.py RandomColorJitter :692-717).

    One enhancement factor f ~ U(lo, hi) per clip for each of brightness,
    contrast, color (saturation), applied in that fixed PIL order:
      brightness: f·x ; contrast: blend with the mean luma ; color: blend
      with the per-pixel luma. ``frames`` are floats in [0, 1] (pre mean/std).
    ``widths`` (B,) restricts the contrast mean to the unpadded content
    region. ``mean_luma`` (B, 1, 1, 1, 1) gives that mean of the frames
    before the brightness factor instead, for frames that are a crop of
    the canvas it was taken over: every step here is affine per clip and
    linear over pixels, so it commutes with the crop's lerps.
    """
    b = frames.shape[0]
    shape = (b, 1, 1, 1, 1)
    fb = _uniform(generator, shape, lo, hi).to(frames.device)
    fc = _uniform(generator, shape, lo, hi).to(frames.device)
    fs = _uniform(generator, shape, lo, hi).to(frames.device)

    x = frames * fb  # brightness: blend with black
    if mean_luma is None:
        mean_l = content_mean_luma(x, widths)
    else:
        mean_l = mean_luma * fb
    x = fc * x + (1.0 - fc) * mean_l  # contrast
    return fs * x + (1.0 - fs) * luma(x)  # color/saturation


def transform_boxes_to_crop(boxes, crop_boxes, out_size: int) -> torch.Tensor:
    """(B, N, 4) [x1, y1, x2, y2] canvas-pixel boxes through each clip's
    crop window (B, 4) [y0, x0, y1, x1] into ``out_size`` crop pixels,
    clipped to the crop (reference: cv2_transform's scale and crop box
    co-transforms)."""
    boxes = torch.as_tensor(boxes)
    crop_boxes = _on(crop_boxes, boxes.device)
    y0, x0, y1, x1 = (crop_boxes[:, i] for i in range(4))
    sx = out_size / torch.clamp(x1 - x0, min=1e-6)
    sy = out_size / torch.clamp(y1 - y0, min=1e-6)
    out = torch.stack([
        (boxes[..., 0] - x0[:, None]) * sx[:, None],
        (boxes[..., 1] - y0[:, None]) * sy[:, None],
        (boxes[..., 2] - x0[:, None]) * sx[:, None],
        (boxes[..., 3] - y0[:, None]) * sy[:, None],
    ], dim=-1)
    return torch.clamp(out, 0.0, out_size - 1.0)


def horizontal_flip_with_boxes(generator, frames: torch.Tensor, boxes,
                               prob: float = 0.5, do=None):
    """Per-clip flip of the clip and its (B, N, 4) [x1, y1, x2, y2] pixel
    boxes (reference: cv2_transform.horizontal_flip_list); ``do`` (B,)
    bools, where given, are the decisions instead of draws."""
    b, _, _, w, _ = frames.shape
    if do is None:
        do = _rand(generator, (b,)) < prob
    do = torch.as_tensor(do).to(frames.device, non_blocking=True)
    frames = torch.where(do[:, None, None, None, None], frames.flip(3),
                         frames)
    fboxes = torch.stack([(w - 1.0) - boxes[..., 2], boxes[..., 1],
                          (w - 1.0) - boxes[..., 0], boxes[..., 3]], dim=-1)
    return frames, torch.where(do[:, None, None], fboxes, boxes)


def _blend(a, b, alpha):
    return alpha * a + (1.0 - alpha) * b


def brightness_jitter(alpha, frames):
    """Blend with black by per-clip factors ``alpha`` (B,)."""
    return _blend(frames, torch.zeros_like(frames),
                  alpha[:, None, None, None, None])


def contrast_jitter(alpha, frames):
    """Blend with each frame's mean over pixels and channels."""
    gray = frames.mean(dim=(2, 3, 4), keepdim=True)
    return _blend(frames, gray, alpha[:, None, None, None, None])


def saturation_jitter(alpha, frames):
    """Blend with each pixel's mean over channels."""
    gray = frames.mean(dim=-1, keepdim=True)
    return _blend(frames, gray, alpha[:, None, None, None, None])


def color_jitter(generator, frames, brightness=0.0, contrast=0.0,
                 saturation=0.0, order=None, alphas=None):
    """Brightness, contrast and saturation jitter in a random order, one
    order a batch (reference transform.py:542-580, cv2_transform
    color_jitter_list). Each factor is 1 + U(−var, var) per clip.
    ``order`` (a permutation of 0, 1, 2) and ``alphas`` (3, B), where
    given, are the draws instead."""
    b = frames.shape[0]
    if order is None:
        order = torch.randperm(3, generator=generator,
                               device=generator.device)
    if alphas is None:
        var = torch.tensor([brightness, contrast, saturation],
                           device=generator.device)[:, None]
        alphas = 1.0 + _uniform(generator, (3, b), -1.0, 1.0, dim=1) * var
    alphas = _on(alphas, frames.device)
    fns = [(brightness, brightness_jitter), (contrast, contrast_jitter),
           (saturation, saturation_jitter)]
    for i in torch.as_tensor(order).tolist():
        var, fn = fns[i]
        if var:
            frames = fn(alphas[i], frames)
    return frames


def lighting_jitter(generator, frames, alphastd, eigval, eigvec, alpha=None):
    """PCA lighting noise (reference: transform.py:636-664): per clip, the
    RGB offset Σ_j α_j λ_j v_j with α ~ N(0, alphastd²) (B, 3); ``alpha``,
    where given, is the draw instead."""
    if alphastd == 0.0:
        return frames
    b = frames.shape[0]
    if alpha is None:
        alpha = _rand(generator, (b, 3), normal=True) * alphastd
    alpha = _on(alpha, frames.device)
    eigval = _on(eigval, frames.device)
    eigvec = _on(eigvec, frames.device)
    rgb = (alpha[:, None, :] * eigval[None, None, :]
           * eigvec[None, :, :]).sum(-1)
    return frames + rgb[:, None, None, None, :]
