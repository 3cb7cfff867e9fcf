"""Clip datasets on the host (port of ``data/datasets.py``; reference:
slowfast/datasets/kinetics.py:20-262, jester.py, and the fork's frame-folder
wheel/tired loaders, decoder.py:476-1041).

Host contract (see data/preprocess.py): every sample is a dict
  frames  uint8 (T, S, Wc, 3) — short side S, true width `width`, right-padded
  width   int32
  portrait int32 (1: a tall clip stored transposed)
  label   int64 (multi-hot float32 for a multi-label dataset)
  index   int64 video index
  spatial_idx / temporal_idx  int32 (test mode; -1 in train/val)
  crop_u  float32 (train/val: the random crop's long-axis position)

Temporal sampling happens at decode time; spatial work happens on the
card. A split is a list file of ``path label`` lines (``LIST_FILES`` under
DATA.PATH_TO_DATA_DIR, the fork's names as a fallback), read for every
backend; the synthetic backend replaces it with seeded frames (no files,
byte-identical to the JAX package's for the same RNG_SEED, video and
view). ``Kinetics`` and ``Jester`` decode video files with the port's
native FFmpeg library (data/decoder.py): only the clip window, at the
canvas short side; a test video's temporal views come from one union
decode where the media allows it. ``Framefolder`` (``Wheel``, ``Tired``,
``Wheel_gray``) reads a folder of JPEG/PNG frames per line.

Every random draw of an item comes from ``np.random.default_rng([RNG_SEED,
epoch, index])``, so the loader's threads give the same run in any order;
the JAX package draws the same quantities from the global ``random``.
"""

from __future__ import annotations

import collections
import glob
import math
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..utils.logging import get_logger
from . import decoder
from .build import DATASET_REGISTRY

logger = get_logger(__name__)

#: the default long-axis decode cap as a multiple of the short side, the
#: default of ``cfg.TPU.DECODE_MAX_ASPECT``. The canvas is 2:1, but the
#: reference's crop protocols span the full long axis at any aspect
#: (slowfast/datasets/transform.py:359-468): content up to the cap is
#: decoded, and ``fit_canvas_into`` cuts the 2:1 window per test view or
#: train draw; content beyond it (no mainstream media) is centre-cropped to
#: the cap first, with a one-time warning.
TEST_DECODE_ASPECT = 4.0


def canvas_width(short_side: int) -> int:
    return short_side * 2


def get_random_sampling_rate(long_cycle_sampling_rate, sampling_rate,
                             rng: np.random.Generator):
    """The multigrid long cycle's sampling rate, drawn from ``rng`` between
    the cfg's rate and the long cycle's (reference: datasets/utils.py:
    318-329)."""
    if long_cycle_sampling_rate > 0:
        assert long_cycle_sampling_rate >= sampling_rate
        return int(rng.integers(sampling_rate, long_cycle_sampling_rate,
                                endpoint=True))
    return sampling_rate


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


class CanvasDataset:
    """What every clip and frame-list dataset shares: the split's items as
    ``_fetch(index)`` → (frames, scalars), each pasted into the (T, S,
    canvas_width(S), 3) canvas by ``__getitem__`` or, on the loader's
    preallocated path, straight into its batch slot by ``getitem_into``.
    Subclasses set ``cfg``, ``mode``, ``epoch`` and ``_path_to_videos``."""

    def set_epoch(self, epoch: int):
        """The epoch whose draws ``_fetch`` makes."""
        self.epoch = epoch

    def _rng(self, index: int) -> np.random.Generator:
        """This item's draws: seeded by (RNG_SEED, epoch, index), so a run
        is the same whatever order the loader's threads fetch in."""
        return np.random.default_rng([self.cfg.RNG_SEED, self.epoch, index])

    def _short_side(self) -> int:
        if self.mode in ("train", "val"):
            return int(self.cfg.DATA.TRAIN_JITTER_SCALES[1])
        return int(self.cfg.DATA.TEST_CROP_SIZE)

    def __len__(self):
        return len(self._path_to_videos)

    def _fetch(self, index: int):
        raise NotImplementedError

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


class ClipDataset(CanvasDataset):
    """Shared logic for list-file clip datasets (Kinetics pattern)."""

    #: whether a test video's temporal views are tried as one union decode
    UNION_DECODE = True

    #: the list file of each split under DATA.PATH_TO_DATA_DIR
    LIST_FILES = {"train": "train.csv", "val": "val.csv", "test": "test.csv"}
    #: the fork's list names, read where LIST_FILES' is missing
    #: (reference: kinetics.py:80-87 hardcodes these)
    FORK_LIST_FILES: dict = {}

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
        # paths the union decode declined for good (-14/-15/-16): later
        # items go straight to the per-view memo
        self._union_unsupported: set = set()
        # path → its exact long-axis extent at this mode's short side, which
        # sizes later decode buffers (a file's aspect is constant)
        self._decode_width_cache: dict = {}
        self._max_aspect = float(cfg.TPU.DECODE_MAX_ASPECT)
        self._warned_aspect_cap = False
        self._synth_lock = threading.Lock()
        self._synth_buf = None
        self._synth_blended = {}

    # -- path list -------------------------------------------------------
    def _list_file(self) -> str:
        primary = os.path.join(
            self.cfg.DATA.PATH_TO_DATA_DIR, self.LIST_FILES[self.mode])
        if not os.path.exists(primary) and self.FORK_LIST_FILES:
            alt = os.path.join(self.cfg.DATA.PATH_TO_DATA_DIR,
                               self.FORK_LIST_FILES[self.mode])
            if os.path.exists(alt):
                return alt
        return primary

    def _construct_loader(self):
        self._path_to_videos: List[str] = []
        self._labels: List[int] = []
        self._spatial_temporal_idx: List[int] = []
        if self.cfg.DATA.DECODING_BACKEND == "synthetic":
            num = 64 if self.mode != "test" else 8
            for i in range(num):
                for clip in range(self._num_clips):
                    self._path_to_videos.append(f"synthetic://{i}")
                    self._labels.append(i % self.cfg.MODEL.NUM_CLASSES)
                    self._spatial_temporal_idx.append(clip)
            self._set_sample_weights()
            return
        path_file = self._list_file()
        assert os.path.exists(path_file), f"{path_file} not found"
        with open(path_file, "r") as f:
            for line in f.read().splitlines():
                parts = line.split(self.cfg.DATA.PATH_LABEL_SEPARATOR)
                assert len(parts) == 2, f"bad list line: {line!r}"
                path, label = parts
                for idx in range(self._num_clips):
                    self._path_to_videos.append(
                        os.path.join(self.cfg.DATA.PATH_PREFIX, path))
                    self._labels.append(int(label))
                    self._spatial_temporal_idx.append(idx)
        assert self._path_to_videos, f"Failed to load split {self.mode}"
        self._set_sample_weights()
        logger.info("Constructed dataset (size: %d) from %s",
                    len(self._path_to_videos), path_file)

    def _set_sample_weights(self):
        """Inverse-class-frequency weights for the loader's weighted sampler
        (reference: MODEL.WEIGHTED_RANDOM_SAMPLER, custom_config.py:7-35)."""
        if not (self.cfg.MODEL.WEIGHTED_RANDOM_SAMPLER
                and self.mode == "train"):
            return
        labels = np.asarray(self._labels, np.int64)
        counts = np.bincount(labels, minlength=int(labels.max()) + 1)
        self.sample_weights = 1.0 / np.maximum(counts[labels], 1)

    def _check_aspect_cap(self, frames: Optional[np.ndarray]):
        """``frames``, with a one-time warning where the TPU.DECODE_MAX_ASPECT
        cap engaged: a decoded long axis that fills the cap is at, or was
        centre-cropped from beyond, the cap."""
        if frames is None or self._warned_aspect_cap:
            return frames
        long_axis = max(frames.shape[-3], frames.shape[-2])
        if long_axis >= int(round(self._max_aspect * self._short_side())):
            self._warned_aspect_cap = True
            logger.warning(
                "content at/beyond the TPU.DECODE_MAX_ASPECT=%.2f cap: "
                "media longer than %.2f:1 is center-cropped to the cap "
                "before the crop protocols (raise the cfg key to widen)",
                self._max_aspect, self._max_aspect)
        return frames

    def _remember_width(self, path: str, hint, extent: int):
        if hint is None and len(self._decode_width_cache) < 1_000_000:
            self._decode_width_cache[path] = extent

    # -- decode ----------------------------------------------------------
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

    def _decode_clip(self, index: int, temporal_idx: int,
                     rng: np.random.Generator) -> Optional[np.ndarray]:
        """NUM_FRAMES frames of clip ``temporal_idx`` (RGB uint8 THWC), or
        None where the read failed; a random window draws from ``rng``.

        Synthetic frames are shifted views of one seeded noise buffer with
        a label-keyed constant colour blended in 50/50 (a colour survives
        any crop, flip and normalization, so the task is learnable), the
        JAX package's bytes exactly (datasets.py:396-435).
        """
        path = self._path_to_videos[index]
        if not path.startswith("synthetic://"):
            return self._decode_file(path, temporal_idx, rng)
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

    def _decode_file(self, path: str, temporal_idx: int,
                      rng: np.random.Generator) -> Optional[np.ndarray]:
        """The video file's clip ``temporal_idx`` of the test views, or in
        train and val a random window (one draw from ``rng``, after the
        long cycle's sampling rate in train), every mode keeping the long
        axis up to the aspect cap: test windows it per view, train and val
        at the crop's draw (``fit_canvas_into``)."""
        cfg = self.cfg
        sampling = (get_random_sampling_rate(
            cfg.MULTIGRID.LONG_CYCLE_SAMPLING_RATE, cfg.DATA.SAMPLING_RATE,
            rng) if self.mode == "train" else cfg.DATA.SAMPLING_RATE)
        hint = self._decode_width_cache.get(path)
        frames = decoder.decode_clip(
            path, num_frames=cfg.DATA.NUM_FRAMES, sampling_rate=sampling,
            clip_idx=temporal_idx,
            num_clips=cfg.TEST.NUM_ENSEMBLE_VIEWS if self.mode == "test" else 1,
            target_fps=cfg.DATA.TARGET_FPS, short_side=self._short_side(),
            random_clip=self.mode in ("train", "val"),
            multi_thread=cfg.DATA_LOADER.ENABLE_MULTI_THREAD_DECODE,
            max_aspect=self._max_aspect, width_hint=hint, rng=rng)
        if frames is not None:
            self._remember_width(path, hint, max(frames.shape[1],
                                                 frames.shape[2]))
        return self._check_aspect_cap(frames)

    def _decode_all_views(self, index: int) -> Optional[np.ndarray]:
        """Every temporal test view of the video at ``index``, (
        NUM_ENSEMBLE_VIEWS, T, H, W, 3), from one union decode: the views
        overlap, so about two sequential decodes serve them all. None where
        the decode failed; ``decoder.UnionUnsupported`` where the media
        cannot take the union, whose views the per-view memo then decodes
        in parallel on the loader's threads."""
        cfg = self.cfg
        path = self._path_to_videos[index]
        hint = self._decode_width_cache.get(path)
        frames = decoder.decode_views(
            path, num_frames=cfg.DATA.NUM_FRAMES,
            sampling_rate=cfg.DATA.SAMPLING_RATE,
            num_clips=cfg.TEST.NUM_ENSEMBLE_VIEWS,
            target_fps=cfg.DATA.TARGET_FPS, short_side=self._short_side(),
            multi_thread=cfg.DATA_LOADER.ENABLE_MULTI_THREAD_DECODE,
            max_aspect=self._max_aspect, width_hint=hint)
        if frames is not None:
            self._remember_width(path, hint, max(frames.shape[2],
                                                 frames.shape[3]))
        return self._check_aspect_cap(frames)

    def _union_views(self, index: int) -> Optional[np.ndarray]:
        """The union decode of ``index``'s video through the test memo (one
        entry holds every view), or None where it is not to be tried or
        failed. Only a structural refusal marks the path for good: a failure
        that may be transient leaves the union to be tried again."""
        path = self._path_to_videos[index]
        if (not self.UNION_DECODE or path.startswith("synthetic://")
                or path in self._union_unsupported):
            return None
        try:
            return self._test_decode_memo.get_or_compute(
                path, lambda: self._decode_all_views(index))
        except decoder.UnionUnsupported:
            if len(self._union_unsupported) < 1_000_000:
                self._union_unsupported.add(path)
            return None

    # -- dataset protocol ------------------------------------------------
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
        rng = self._rng(index)
        # decode with retry + random replacement (reference kinetics.py:192-255)
        # — replacement only outside test mode: the multi-view TestMeter
        # requires every video's full clip set
        for retry in range(self._num_retries):
            if self._test_decode_memo is not None:
                # the union decode of every view where the media takes it,
                # else one decode per (path, view), shared by the spatial
                # crops (test-mode decodes draw nothing)
                frames = self._union_views(index)
                if frames is not None:
                    frames = frames[temporal_idx]
                else:
                    frames = self._test_decode_memo.get_or_compute(
                        (self._path_to_videos[index], temporal_idx),
                        lambda: self._decode_clip(index, temporal_idx, rng))
            else:
                frames = self._decode_clip(index, temporal_idx, rng)
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


@DATASET_REGISTRY.register()
class Kinetics(ClipDataset):
    """Kinetics (reference: kinetics.py): a list of ``video label`` lines,
    each video decoded from its file."""

    # the wdf fork hardcodes these names with test->val aliasing
    FORK_LIST_FILES = {
        "train": "kinetics_p3d_train_byvideo_128.lst",
        "val": "kinetics_p3d_val_byvideo_128.lst",
        "test": "kinetics_p3d_val_byvideo_128.lst",
    }


@DATASET_REGISTRY.register()
class Jester(ClipDataset):
    """Jester lists are trainlist/vallist; test aliases to val
    (reference: jester.py:80-87); its videos decode from their files."""

    LIST_FILES = {
        "train": "trainlist.txt", "val": "vallist.txt", "test": "vallist.txt",
    }


@DATASET_REGISTRY.register()
class Framefolder(ClipDataset):
    """Frame-folder clips: each list line is ``dir_of_frames label``; the
    frames are the sorted JPEGs and PNGs inside. The fork's private
    wheel/tired/smoke datasets' layout (reference: decoder.py
    wheel_decoder* :476-1041), with DATA.HALF_FACE's top half and
    DATA.GRAY_STYLE's pipeline (``_gray_style``)."""

    LIST_FILES = {"train": "train.txt", "val": "val.txt", "test": "val.txt"}
    # a folder of frames is no video file: its views are read one by one
    UNION_DECODE = False

    def _list_file(self) -> str:
        """The fork's explicit list files where set
        (DATA.PATH_TO_TRAIN_DATA_TXT / PATH_TO_VAL_DATA_TXT; test reads the
        val list, as the reference's loaders do)."""
        explicit = (self.cfg.DATA.PATH_TO_TRAIN_DATA_TXT
                    if self.mode == "train"
                    else self.cfg.DATA.PATH_TO_VAL_DATA_TXT)
        return explicit or super()._list_file()

    def _decode_clip(self, index, temporal_idx, rng):
        path = self._path_to_videos[index]
        if path.startswith("synthetic://"):
            return super()._decode_clip(index, temporal_idx, rng)
        from .frame_datasets import retry_load_images

        files = sorted(glob.glob(os.path.join(path, "*.jpg"))
                       + glob.glob(os.path.join(path, "*.png")))
        if not files:
            return None
        cfg = self.cfg
        num_frames = cfg.DATA.NUM_FRAMES
        start, end = get_start_end_idx(
            len(files), cfg.DATA.SAMPLING_RATE * num_frames,
            -1 if self.mode in ("train", "val") else temporal_idx,
            cfg.TEST.NUM_ENSEMBLE_VIEWS, rng)
        idx = np.clip(np.round(np.linspace(start, end, num_frames)), 0,
                      len(files) - 1).astype(np.int64)
        frames = retry_load_images([files[i] for i in idx], self._num_retries)
        if cfg.DATA.GRAY_STYLE:
            return self._gray_style(frames, rng)
        if cfg.DATA.HALF_FACE:
            # top-half crop (reference: tired dataset half-face option)
            frames = frames[:, : frames.shape[1] // 2]
        return frames

    def _gray_style(self, frames: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
        """Gray-style pipeline (reference: decoder.py
        wheel/smoke_decoder_gray_style :607-1041): grayscale, a random
        top-left corner crop of at most 10% (train/val), the half-face crop
        (a ratio in [0.5, 0.6], 0.55 in test), a square resize to the
        canvas short side, train-only rotate + salt noise. Brightness
        jitter and flip ride the train preprocess on the card."""
        from PIL import Image

        from . import host_transforms as HT

        t, h, w, _ = frames.shape
        # grayscale, replicated to 3 channels (reference convert("L"))
        luma = (frames.astype(np.float32)
                @ np.asarray([0.299, 0.587, 0.114], np.float32))
        gray = np.repeat(np.clip(luma, 0, 255).astype(np.uint8)[..., None],
                         3, axis=-1)
        train_or_val = self.mode in ("train", "val")
        y0 = x0 = 0
        if train_or_val:
            x0 = int(rng.integers(0, max(int(0.1 * w) - 1, 0), endpoint=True))
            y0 = int(rng.integers(0, max(int(0.1 * h) - 1, 0), endpoint=True))
        y1 = h
        if self.cfg.DATA.HALF_FACE:
            # eval preprocessing stays deterministic run to run
            r = 0.5 + 0.1 * rng.random() if train_or_val else 0.55
            y1 = int(r * h)
        gray = gray[:, y0:y1, x0:]
        s = self._short_side()
        out = np.empty((t, s, s, 3), np.uint8)
        for i in range(t):
            out[i] = np.asarray(
                Image.fromarray(gray[i]).resize((s, s), Image.BILINEAR))
        if self.mode == "train":
            out = HT.Compose([HT.RandomRotate(), HT.SaltImage()])(out, rng)
        return out


@DATASET_REGISTRY.register()
class Wheel(Framefolder):
    """Steering-wheel dataset alias (reference: datasets/wheel*)."""


@DATASET_REGISTRY.register()
class Tired(Framefolder):
    """Fatigue/eye-state dataset alias (reference: datasets/tired*)."""


@DATASET_REGISTRY.register()
class Wheel_gray(Framefolder):
    """Gray-style wheel dataset — ``DATASET: wheel_gray`` in the fork's
    TIRED configs (the registry's capitalize() → "Wheel_gray"): the
    gray-style decode whatever DATA.GRAY_STYLE says (reference: decoder.py
    wheel_decoder_gray_style)."""

    def __init__(self, cfg, mode, num_retries=10):
        cfg = cfg.clone()
        cfg.DATA.GRAY_STYLE = True
        super().__init__(cfg, mode, num_retries)


@DATASET_REGISTRY.register()
class Synthetic(ClipDataset):
    """Pure synthetic frames for tests/benchmarks regardless of backend."""

    def __init__(self, cfg, mode, num_retries=10):
        cfg = cfg.clone()
        cfg.DATA.DECODING_BACKEND = "synthetic"
        super().__init__(cfg, mode, num_retries)
