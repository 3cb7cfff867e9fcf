"""Frame-list datasets: Something-Something V2 and Charades (port of
``data/frame_datasets.py``; reference: slowfast/datasets/ssv2.py:21-263,
charades.py:19-237, and the helpers of datasets/utils.py).

A split is an fvcore-style frame list (``original_vido_id video_id
frame_id path labels``): one JPEG a line. Items follow the clip datasets'
host contract (data/datasets.py): a (T, S, canvas_width(S), 3) uint8
canvas, its width and the label (SSv2 an int64 class, Charades a
multi-hot float32 vector); the spatial work happens on the card. Both
ride the loader's preallocated path (``getitem_into``), and a test view's
spatial crops share one read of its frames.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from itertools import chain
from typing import List

import numpy as np

from ..utils.logging import get_logger
from .build import DATASET_REGISTRY
from .datasets import CanvasDataset, _DecodeMemo

logger = get_logger(__name__)


def load_image_lists(frame_list_file: str, prefix: str = "",
                     return_list: bool = False):
    """Parse a frame list (header + ``original_vido_id video_id frame_id
    path labels`` rows). Returns (paths, labels) keyed by video name, or as
    lists in the file's order of videos; a frame's labels are a list of
    ints (empty for ``""``)."""
    image_paths = defaultdict(list)
    labels = defaultdict(list)
    with open(frame_list_file, "r") as f:
        assert f.readline().startswith("original_vido_id")
        for line in f:
            row = line.split()
            if len(row) != 5:
                continue
            video_name = row[0]
            image_paths[video_name].append(os.path.join(prefix, row[3]))
            frame_labels = row[-1].replace('"', "")
            labels[video_name].append(
                [int(x) for x in frame_labels.split(",")]
                if frame_labels != "" else [])
    if return_list:
        keys = list(image_paths.keys())
        return [image_paths[k] for k in keys], [labels[k] for k in keys]
    return dict(image_paths), dict(labels)


def retry_load_images(image_paths: List[str], retry: int = 10) -> np.ndarray:
    """The frames at ``image_paths`` as RGB uint8 (T, H, W, 3), read with
    PIL, retried ``retry`` times before raising (reference:
    datasets/utils.py:19-49)."""
    from PIL import Image

    for r in range(retry):
        try:
            imgs = []
            for p in image_paths:
                with Image.open(p) as im:
                    imgs.append(np.asarray(im.convert("RGB"), np.uint8))
            return np.stack(imgs)
        except Exception:
            logger.warning("Reading failed (attempt %d). Retry.", r)
    raise RuntimeError(f"Failed to load images {image_paths}")


def aggregate_labels(label_list) -> List[int]:
    """Sorted union of frame-level label lists (reference: datasets/utils.py)."""
    return sorted(set(chain.from_iterable(label_list)))


def as_binary_vector(labels, num_classes: int) -> np.ndarray:
    vec = np.zeros(num_classes, np.float32)
    for label in labels:
        vec[int(label)] = 1.0
    return vec


class _FrameListDataset(CanvasDataset):
    """Shared machinery: the split's views and the test-mode read memo."""

    def __init__(self, cfg, mode: str, num_retries: int = 10):
        assert mode in ("train", "val", "test")
        self.cfg = cfg
        self.mode = mode
        self.epoch = 0
        self._num_retries = num_retries
        self._num_clips = (
            1 if mode in ("train", "val")
            else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        )
        # multi-view test: eval-mode temporal sampling is deterministic, so
        # the NUM_SPATIAL_CROPS items of a view (all the items of a video
        # for SSv2, whose eval sampling ignores the view) read the same
        # frames: one read serves them
        self._test_decode_memo = _DecodeMemo() if mode == "test" else None

    def _list_file(self) -> str:
        return os.path.join(self.cfg.DATA.PATH_TO_DATA_DIR,
                            f"{'train' if self.mode == 'train' else 'val'}.csv")

    def _set_views(self, paths, labels):
        """Each video's frame paths and label, once per test view."""
        self._path_to_videos = list(chain.from_iterable(
            [[x] * self._num_clips for x in paths]))
        self._labels = list(chain.from_iterable(
            [[x] * self._num_clips for x in labels]))
        logger.info("%s %s: %d clips", type(self).__name__, self.mode,
                    len(self._path_to_videos))

    def _load_frames(self, index: int, temporal_idx: int, seq):
        """The frames ``seq`` of item ``index``; in test mode one read per
        (video, view), shared by its spatial crops (a failed read raises
        and is not kept)."""
        read = lambda: retry_load_images(  # noqa: E731
            [self._path_to_videos[index][f] for f in seq], self._num_retries)
        if self._test_decode_memo is None:
            return read()
        return self._test_decode_memo.get_or_compute(
            (index // self._num_clips, temporal_idx), read)

    def _scalars(self, index, label, spatial_idx, temporal_idx, rng):
        out = {
            "label": label,
            "index": np.int64(index // self._num_clips
                              if self.mode == "test" else index),
            "spatial_idx": np.int32(spatial_idx),
            "temporal_idx": np.int32(temporal_idx),
        }
        if self.mode in ("train", "val"):
            # the long-axis position of the random crop, shared between the
            # host canvas window and the preprocess crop box
            out["crop_u"] = np.float32(rng.random())
        return out


@DATASET_REGISTRY.register()
class Ssv2(_FrameListDataset):
    """Something-Something V2 (reference: ssv2.py): label jsons + frame
    lists; segment-based temporal sampling (train: a random frame in each
    segment; eval: the segments' centres)."""

    def __init__(self, cfg, mode: str, num_retries: int = 10):
        super().__init__(cfg, mode, num_retries)
        d = cfg.DATA.PATH_TO_DATA_DIR
        with open(os.path.join(d, "something-something-v2-labels.json")) as f:
            label_dict = json.load(f)
        split = "train" if mode == "train" else "validation"
        with open(os.path.join(d, f"something-something-v2-{split}.json")) as f:
            label_json = json.load(f)
        paths, _ = load_image_lists(self._list_file(), cfg.DATA.PATH_PREFIX)
        videos, labels = [], []
        for video in label_json:
            template = video["template"].replace("[", "").replace("]", "")
            if video["id"] in paths:
                videos.append(paths[video["id"]])
                labels.append(int(label_dict[template]))
        self._set_views(videos, labels)

    def _fetch(self, index: int):
        num_frames = self.cfg.DATA.NUM_FRAMES
        rng = self._rng(index)
        seg_size = float(len(self._path_to_videos[index]) - 1) / num_frames
        seq = []
        for i in range(num_frames):
            start = int(np.round(seg_size * i))
            end = int(np.round(seg_size * (i + 1)))
            seq.append(int(rng.integers(start, end, endpoint=True))
                       if self.mode == "train" else (start + end) // 2)
        frames = self._load_frames(index, 0, seq)
        spatial_idx = (-1 if self.mode in ("train", "val")
                       else index % self.cfg.TEST.NUM_SPATIAL_CROPS)
        return frames, self._scalars(index, np.int64(self._labels[index]),
                                     spatial_idx, 0, rng)


@DATASET_REGISTRY.register()
class Charades(_FrameListDataset):
    """Charades, multi-label (reference: charades.py): frame lists with
    per-frame labels; a clip's label is the union over the frames it
    spans, as a multi-hot float32 vector."""

    def __init__(self, cfg, mode: str, num_retries: int = 10):
        super().__init__(cfg, mode, num_retries)
        self._set_views(*load_image_lists(
            self._list_file(), cfg.DATA.PATH_PREFIX, return_list=True))

    def _fetch(self, index: int):
        cfg = self.cfg
        num_frames = cfg.DATA.NUM_FRAMES
        sampling = cfg.DATA.SAMPLING_RATE
        rng = self._rng(index)
        video_length = len(self._path_to_videos[index])
        clip_length = (num_frames - 1) * sampling + 1
        if self.mode in ("train", "val"):
            lo, hi = sorted((0, video_length - clip_length))
            start = int(rng.integers(lo, hi, endpoint=True))
            temporal_idx = 0
        else:
            temporal_idx = (index % self._num_clips) // cfg.TEST.NUM_SPATIAL_CROPS
            views = cfg.TEST.NUM_ENSEMBLE_VIEWS
            gap = (float(max(video_length - clip_length, 0)) / (views - 1)
                   if views > 1 else 0)
            start = int(round(gap * temporal_idx))
        seq = [max(min(start + i * sampling, video_length - 1), 0)
               for i in range(num_frames)]
        frames = self._load_frames(index, temporal_idx, seq)
        label = as_binary_vector(
            aggregate_labels(self._labels[index][seq[0]:seq[-1] + 1]),
            cfg.MODEL.NUM_CLASSES)
        spatial_idx = (-1 if self.mode in ("train", "val")
                       else index % cfg.TEST.NUM_SPATIAL_CROPS)
        return frames, self._scalars(index, label, spatial_idx, temporal_idx,
                                     rng)
