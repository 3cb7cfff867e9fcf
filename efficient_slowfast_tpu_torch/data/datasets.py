"""Clip datasets on the host (port of ``data/datasets.py``; reference:
slowfast/datasets/kinetics.py:20-262).

Host contract (see data/preprocess.py): every sample is a dict
  frames  uint8 (T, S, Wc, 3) — short side S, true width `width`, right-padded
  width   int32
  portrait int32 (1: a tall clip stored transposed)
  label   int64
  index   int64 video index
  spatial_idx / temporal_idx  int32 (test mode; -1 in train/val)
  crop_u  float32 (train/val: the random crop's long-axis position)

Temporal sampling happens at decode time; spatial work happens on the
card. This slice has the synthetic backend (deterministic frames, no
files, byte-identical to the JAX package's for the same RNG_SEED, video
and view); decoding video files comes with ROADMAP item 2b.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..utils.logging import get_logger
from .build import DATASET_REGISTRY

logger = get_logger(__name__)

_DECODE_LATER = ("decoding video files (DATA.DECODING_BACKEND {!r}) comes "
                 "with ROADMAP item 2b; use the synthetic backend")


def canvas_width(short_side: int) -> int:
    return short_side * 2


def get_start_end_idx(video_size, clip_size, clip_idx, num_clips,
                      rng: Optional[np.random.Generator] = None):
    """Clip window selection (reference: decoder.py:55-83); a random window
    (clip_idx -1) draws from ``rng``."""
    delta = max(video_size - clip_size, 0)
    if clip_idx == -1:
        start_idx = (rng or np.random.default_rng()).uniform(0, delta)
    else:
        start_idx = delta * clip_idx / num_clips
    end_idx = start_idx + clip_size - 1
    return start_idx, end_idx


def temporal_sample_np(frames: np.ndarray, start_idx, end_idx, num_samples):
    """Host-side linspace frame selection (reference: decoder.py:35-52)."""
    t = frames.shape[0]
    idx = np.linspace(start_idx, end_idx, num_samples)
    idx = np.clip(np.round(idx), 0, t - 1).astype(np.int64)
    return frames[idx]


def fit_canvas_into(frames: np.ndarray, short: int,
                    out: np.ndarray, keep_portrait: bool = False,
                    long_view: int = -1,
                    window_u: Optional[float] = None):
    """``fit_canvas`` writing straight into a preallocated canvas slot
    (the loader's batch array, or a pinned host buffer), in one pass over
    the frame bytes.

    Returns ``(width, portrait)``. With ``keep_portrait`` tall (h > w) clips
    are stored TRANSPOSED (a pure axis swap, exactly invertible): the canvas
    stays landscape with height == short, and the preprocess crops along
    the canvas x axis — the original VERTICAL axis — then swaps the square
    crop back (data/preprocess.py). This is the reference's 3-position
    top/center/bottom test protocol for portrait media (reference:
    slowfast/datasets/transform.py:425-468 uniform_crop).

    ``long_view`` positions the canvas window on content whose long axis
    exceeds the 2:1 canvas. The reference's test crops sit at 0 /
    ceil((L-S)/2) / L-S of the full resized long axis L
    (transform.py:447-460, S = crop == ``short`` here); the preprocess crop
    then lands at 0 / ceil((wc-S)/2) / wc-S of the window
    (transform.uniform_crop_boxes), so window start = reference position −
    preprocess position makes the composition exact per view k ∈ {0, 1, 2}.

    ``window_u`` (train/val, long_view = −1): the host's uniform draw
    u ∈ [0, 1] for the random crop's long-axis position. The window starts
    at ``round(u·(L−wc))`` and the preprocess crop, fed the same u
    (transform.random_scale_crop_boxes u_x), lands at ``u·(wc−win)`` inside
    it, composing to ``u·(L−win)``: uniform over the full resized long
    axis, the reference's random_crop range (transform.py:359-392). Without
    it (or with long_view ∉ {0,1,2}) the center window is kept.
    """
    t, h, w, _ = frames.shape
    wc = canvas_width(short)
    portrait = 0
    if keep_portrait and h > w:
        frames = np.swapaxes(frames, 1, 2)
        h, w = w, h
        portrait = 1
    if h <= w:
        new_h, new_w = short, max(short, int(round(w * short / h)))
    else:
        new_h, new_w = int(round(h * short / w)), short
    if (new_h, new_w) != (h, w):
        frames = _resize_bilinear(frames, new_h, new_w)
    # crop vertical extent to short (centered)
    if frames.shape[1] > short:
        off = (frames.shape[1] - short) // 2
        frames = frames[:, off: off + short]
    # crop horizontal extent to canvas width, positioned per long_view
    if frames.shape[2] > wc:
        length = frames.shape[2]
        if long_view == 0:
            off = 0
        elif long_view == 1:
            off = (math.ceil((length - short) / 2)
                   - math.ceil((wc - short) / 2))
        elif long_view == 2:
            off = length - wc
        elif window_u is not None:
            off = int(round(window_u * (length - wc)))
        else:
            off = (length - wc) // 2
        off = min(max(off, 0), length - wc)
        frames = frames[:, :, off: off + wc]
    width = frames.shape[2]
    out[:, :, :width] = frames
    if width < wc:
        out[:, :, width:] = 0
    return width, portrait


def fit_canvas(frames: np.ndarray, short: int,
               keep_portrait: bool = False,
               long_view: int = -1,
               window_u: Optional[float] = None) -> Tuple[np.ndarray, int, int]:
    """Resize so the short side == `short` and fit into (short, 2*short).

    Returns (canvas uint8 (T, short, 2*short, 3), true content width,
    portrait flag); see ``fit_canvas_into``.
    """
    out = np.empty((frames.shape[0], short, canvas_width(short), 3), np.uint8)
    width, portrait = fit_canvas_into(frames, short, out,
                                      keep_portrait=keep_portrait,
                                      long_view=long_view,
                                      window_u=window_u)
    return out, width, portrait


def _resize_bilinear(frames: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """PIL-based per-frame bilinear resize of raw-array inputs."""
    from PIL import Image

    out = np.empty((frames.shape[0], new_h, new_w, 3), np.uint8)
    for i in range(frames.shape[0]):
        # ascontiguousarray: transposed portrait storage yields strided views
        out[i] = np.asarray(
            Image.fromarray(np.ascontiguousarray(frames[i]))
            .resize((new_w, new_h), Image.BILINEAR)
        )
    return out


class _DecodeMemo:
    """Compute-once decode cache for the multi-view test protocol.

    The 30-view enumeration (reference kinetics.py:66-110) lists each video
    NUM_ENSEMBLE_VIEWS × NUM_SPATIAL_CROPS times, and the spatial crop
    happens after decode, so the three crops of one temporal view share one
    decode: loader threads asking for the same key wait on one in-flight
    computation. Failed decodes (None) are never cached, so the caller's
    retry really re-attempts. LRU-bounded by entry count and by resident
    bytes; cached arrays are marked read-only (every consumer pastes into
    its own canvas).
    """

    def __init__(self, capacity: int = 8, max_bytes: int = 192 << 20):
        self._cap = capacity
        self._max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict" = collections.OrderedDict()

    def _over_budget(self) -> bool:
        if len(self._entries) > self._cap:
            return True
        total = sum(e[1].nbytes for e in self._entries.values()
                    if e[0].is_set() and e[1] is not None)
        return total > self._max_bytes

    def get_or_compute(self, key, fn):
        with self._lock:
            ent = self._entries.get(key)
            owner = ent is None
            if owner:
                ent = [threading.Event(), None]
                self._entries[key] = ent
                # evict the oldest completed entries beyond the budget (an
                # in-flight decode keeps its slot so waiters stay attached)
                for old_key in list(self._entries):
                    if not self._over_budget():
                        break
                    if old_key != key and self._entries[old_key][0].is_set():
                        del self._entries[old_key]
            else:
                self._entries.move_to_end(key)
        if not owner:
            ent[0].wait()
            return ent[1]  # None on a failed decode -> caller retries
        try:
            value = fn()
        except BaseException:
            with self._lock:
                self._entries.pop(key, None)
            ent[0].set()
            raise
        if value is None:
            with self._lock:
                self._entries.pop(key, None)
        else:
            try:
                value.setflags(write=False)
            except ValueError:
                pass  # read-only views (synthetic path) stay as they are
            ent[1] = value
        ent[0].set()
        return value


class ClipDataset:
    """Shared logic for list-file clip datasets (Kinetics pattern)."""

    def __init__(self, cfg, mode: str, num_retries: int = 10):
        assert mode in ("train", "val", "test"), f"Split '{mode}' not supported"
        self.cfg = cfg
        self.mode = mode
        self._num_retries = num_retries
        self.epoch = 0
        if mode in ("train", "val"):
            self._num_clips = 1
        else:
            self._num_clips = (
                cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
            )
        self._construct_loader()
        # multi-view test: one decode serves all NUM_SPATIAL_CROPS crops
        self._test_decode_memo = _DecodeMemo() if mode == "test" else None
        self._synth_lock = threading.Lock()
        self._synth_buf = None
        self._synth_blended = {}

    def set_epoch(self, epoch: int):
        """The epoch whose draws (crop_u) ``_fetch`` makes."""
        self.epoch = epoch

    def _construct_loader(self):
        if self.cfg.DATA.DECODING_BACKEND != "synthetic":
            raise NotImplementedError(
                _DECODE_LATER.format(self.cfg.DATA.DECODING_BACKEND))
        self._path_to_videos: List[str] = []
        self._labels: List[int] = []
        self._spatial_temporal_idx: List[int] = []
        num = 64 if self.mode != "test" else 8
        for i in range(num):
            for clip in range(self._num_clips):
                self._path_to_videos.append(f"synthetic://{i}")
                self._labels.append(i % self.cfg.MODEL.NUM_CLASSES)
                self._spatial_temporal_idx.append(clip)
        self._set_sample_weights()

    def _set_sample_weights(self):
        """Inverse-class-frequency weights for the loader's weighted sampler
        (reference: MODEL.WEIGHTED_RANDOM_SAMPLER, custom_config.py:7-35)."""
        if not (self.cfg.MODEL.WEIGHTED_RANDOM_SAMPLER
                and self.mode == "train"):
            return
        labels = np.asarray(self._labels, np.int64)
        counts = np.bincount(labels, minlength=int(labels.max()) + 1)
        self.sample_weights = 1.0 / np.maximum(counts[labels], 1)

    # -- decode ----------------------------------------------------------
    def _short_side(self) -> int:
        if self.mode in ("train", "val"):
            return int(self.cfg.DATA.TRAIN_JITTER_SCALES[1])
        return int(self.cfg.DATA.TEST_CROP_SIZE)

    def _synthetic_source(self, label: int):
        """(noise buffer, its blend with ``label``'s colour or None). The
        buffer is drawn once, under a lock (each loader thread would
        otherwise draw it anew); blends are made outside it, in parallel,
        and the first one made for a label is kept."""
        s = self._short_side()
        num_frames = self.cfg.DATA.NUM_FRAMES
        with self._synth_lock:
            buf = self._synth_buf
            if buf is None:
                rs = np.random.RandomState(self.cfg.RNG_SEED)
                buf = rs.randint(0, 255, (num_frames + 64, s, int(s * 4 / 3), 3),
                                 np.uint8)
                self._synth_buf = buf
            blended = self._synth_blended.get(label)
            full = len(self._synth_blended) >= 32  # bound host RAM
        if blended is None and not full:
            color = np.random.RandomState(label + 1).randint(
                0, 256, 3).astype(np.uint8)
            blended = (buf >> 1) + (color >> 1)
            blended.setflags(write=False)  # consumers copy, never edit
            with self._synth_lock:
                blended = self._synth_blended.setdefault(label, blended)
        return buf, blended

    def _decode_clip(self, index: int, temporal_idx: int) -> Optional[np.ndarray]:
        """NUM_FRAMES frames of clip ``temporal_idx`` (RGB uint8 THWC).

        Synthetic frames are shifted views of one seeded noise buffer with
        a label-keyed constant colour blended in 50/50 (a colour survives
        any crop, flip and normalization, so the task is learnable), the
        JAX package's bytes exactly (datasets.py:396-435).
        """
        path = self._path_to_videos[index]
        if not path.startswith("synthetic://"):
            raise NotImplementedError(_DECODE_LATER.format(path))
        num_frames = self.cfg.DATA.NUM_FRAMES
        # video id from the path, not hash(path): PYTHONHASHSEED would give
        # each process different content for the same id
        vid = int(path[len("synthetic://"):])
        off = (vid * 7 + max(temporal_idx, 0)) % 64
        label = vid % self.cfg.MODEL.NUM_CLASSES
        buf, blended = self._synthetic_source(label)
        if blended is None:  # past 32 cached colours: blend this clip only
            color = np.random.RandomState(label + 1).randint(
                0, 256, 3).astype(np.uint8)
            return (buf[off:off + num_frames] >> 1) + (color >> 1)
        return blended[off:off + num_frames]

    # -- dataset protocol ------------------------------------------------
    def __len__(self):
        return len(self._path_to_videos)

    def _fetch(self, index: int):
        """Decode + scalar fields; the canvas paste is done by the caller."""
        cfg = self.cfg
        if self.mode in ("train", "val"):
            temporal_idx, spatial_idx = -1, -1
        else:
            temporal_idx = (
                self._spatial_temporal_idx[index] // cfg.TEST.NUM_SPATIAL_CROPS
            )
            spatial_idx = (
                self._spatial_temporal_idx[index] % cfg.TEST.NUM_SPATIAL_CROPS
            )
        # this item's draws: seeded by (RNG_SEED, epoch, index), so a run is
        # the same whatever order the loader's threads fetch in
        rng = np.random.default_rng([cfg.RNG_SEED, self.epoch, index])
        # decode with retry + random replacement (reference kinetics.py:192-255)
        # — replacement only outside test mode: the multi-view TestMeter
        # requires every video's full clip set
        for retry in range(self._num_retries):
            if self._test_decode_memo is not None:
                # one decode per (path, view), shared by the spatial crops
                frames = self._test_decode_memo.get_or_compute(
                    (self._path_to_videos[index], temporal_idx),
                    lambda: self._decode_clip(index, temporal_idx))
            else:
                frames = self._decode_clip(index, temporal_idx)
            if frames is not None:
                break
            logger.warning("Failed to decode %s; retry %d",
                           self._path_to_videos[index], retry)
            if retry >= 2 and self.mode != "test":
                index = int(rng.integers(0, len(self)))
        else:
            raise RuntimeError(
                f"Failed to fetch video after {self._num_retries} retries."
            )

        if cfg.DATA.REVERSE_INPUT_CHANNEL:
            frames = frames[..., ::-1]
        scalars = {
            "label": np.int64(self._labels[index]),
            "index": np.int64(index // self._num_clips if self.mode == "test"
                              else index),
            "spatial_idx": np.int32(spatial_idx),
            "temporal_idx": np.int32(temporal_idx),
        }
        if self.mode in ("train", "val"):
            # the long-axis position of the random crop, shared between the
            # host canvas window and the preprocess crop box
            scalars["crop_u"] = np.float32(rng.random())
        return frames, scalars

    def __getitem__(self, index: int):
        frames, scalars = self._fetch(index)
        canvas, width, portrait = fit_canvas(
            frames, self._short_side(), keep_portrait=True,
            long_view=int(scalars["spatial_idx"]),
            window_u=(float(scalars["crop_u"])
                      if "crop_u" in scalars else None))
        return {"frames": canvas, "width": np.int32(width),
                "portrait": np.int32(portrait), **scalars}

    # -- preallocated-batch fast path (see ClipLoader) --------------------
    def frames_shape(self) -> Tuple[int, int, int, int]:
        s = self._short_side()
        return (self.cfg.DATA.NUM_FRAMES, s, canvas_width(s), 3)

    def getitem_into(self, index: int, frames_out: np.ndarray) -> dict:
        """__getitem__ pasting the canvas directly into ``frames_out``
        (one pass over the frame bytes instead of canvas-alloc + stack)."""
        frames, scalars = self._fetch(index)
        width, portrait = fit_canvas_into(
            frames, self._short_side(), frames_out, keep_portrait=True,
            long_view=int(scalars["spatial_idx"]),
            window_u=(float(scalars["crop_u"])
                      if "crop_u" in scalars else None))
        return {"width": np.int32(width), "portrait": np.int32(portrait),
                **scalars}


@DATASET_REGISTRY.register()
class Kinetics(ClipDataset):
    """Kinetics (reference: kinetics.py); its list files come with the
    file decoders (ROADMAP item 2b)."""


@DATASET_REGISTRY.register()
class Synthetic(ClipDataset):
    """Pure synthetic frames for tests/benchmarks regardless of backend."""

    def __init__(self, cfg, mode, num_retries=10):
        cfg = cfg.clone()
        cfg.DATA.DECODING_BACKEND = "synthetic"
        super().__init__(cfg, mode, num_retries)
