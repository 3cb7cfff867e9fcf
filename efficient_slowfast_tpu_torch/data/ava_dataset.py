"""AVA keyframe detection dataset (port of ``data/ava_dataset.py``;
reference: slowfast/datasets/ava_dataset.py).

On the host: the NUM_FRAMES × SAMPLING_RATE window of JPEG frames around
each labelled keyframe (read with PIL, short side resized into the fixed
canvas), the normalized person boxes scaled to canvas pixels, and boxes and
labels padded to a fixed ``MAX_BOXES`` a sample with a mask of the real
ones, so every batch has one shape. Train augmentation (scale jitter, crop
and flip with the boxes carried along, colour and PCA jitter) runs on the
card (``data/preprocess.py::make_detection_train_preprocess``).

The loader's preallocated path pastes each canvas straight into its batch
slot (``getitem_into``), so AVA batches ride the pinned host ring too.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..utils.logging import get_logger
from . import ava_helper
from .build import DATASET_REGISTRY
from .datasets import _DecodeMemo, canvas_width, fit_canvas_into

logger = get_logger(__name__)

MAX_BOXES = 32


@DATASET_REGISTRY.register()
class Ava:
    def __init__(self, cfg, split: str):
        self.cfg = cfg
        self._split = split
        self._sample_rate = cfg.DATA.SAMPLING_RATE
        self._video_length = cfg.DATA.NUM_FRAMES
        self._seq_len = self._video_length * self._sample_rate
        self._num_classes = cfg.MODEL.NUM_CLASSES
        # eval keyframes are enumerated video by video at 1 Hz while each
        # window spans seq_len raw frames (~2 s at 32x2), so adjacent items
        # share about half their JPEGs: one read serves them. Train
        # shuffles keyframes globally and reads uncached.
        self._frame_memo = (_DecodeMemo(capacity=192, max_bytes=256 << 20)
                            if split != "train" else None)
        self._load_data(cfg)

    def _load_data(self, cfg):
        self._image_paths, self._video_idx_to_name = (
            ava_helper.load_image_lists(cfg, is_train=self._split == "train"))
        boxes_and_labels = ava_helper.load_boxes_and_labels(
            cfg, mode=self._split)
        self._keyframe_indices, self._keyframe_boxes_and_labels = (
            self._keyframes_in_video_order(boxes_and_labels))
        self._num_boxes_used = ava_helper.get_num_boxes_used(
            self._keyframe_indices, self._keyframe_boxes_and_labels)
        logger.info("AVA %s: %d keyframes, %d boxes", self._split,
                    len(self._keyframe_indices), self._num_boxes_used)

    def _keyframes_in_video_order(self, boxes_and_labels):
        keyframe_indices = []
        keyframe_boxes = []
        for video_idx, name in enumerate(self._video_idx_to_name):
            per_video = []
            sec_idx = 0
            for sec in sorted(boxes_and_labels.get(name, {}).keys()):
                if sec not in ava_helper.AVA_VALID_FRAMES:
                    continue
                entries = boxes_and_labels[name][sec]
                if entries:
                    keyframe_indices.append(
                        (video_idx, sec_idx, sec,
                         ava_helper.frame_sec_to_idx(sec)))
                    per_video.append(entries)
                    sec_idx += 1
            keyframe_boxes.append(per_video)
        return keyframe_indices, keyframe_boxes

    def __len__(self):
        return len(self._keyframe_indices)

    def _short_side(self) -> int:
        if self._split == "train":
            return int(self.cfg.DATA.TRAIN_JITTER_SCALES[0])
        return int(self.cfg.DATA.TEST_CROP_SIZE)

    def frames_shape(self):
        s = self._short_side()
        return (self._video_length, s, canvas_width(s), 3)

    def _frame_window(self, video_idx: int, center_idx: int) -> List[int]:
        """reference datasets/utils.py get_sequence (:50-72)."""
        half = self._seq_len // 2
        seq = list(range(center_idx - half, center_idx + half,
                         self._sample_rate))
        n = len(self._image_paths[video_idx])
        return [min(max(i, 0), n - 1) for i in seq]

    def _read_frame(self, path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.uint8)

    def _load_frames(self, video_idx: int, frame_indices) -> np.ndarray:
        frames = []
        for idx in frame_indices:
            path = self._image_paths[video_idx][idx]
            if self._frame_memo is not None:
                # memo entries are read-only; np.stack below copies
                frames.append(self._frame_memo.get_or_compute(
                    (video_idx, idx), lambda p=path: self._read_frame(p)))
            else:
                frames.append(self._read_frame(path))
        out = np.stack(frames)
        if self.cfg.AVA.BGR:
            # BGR channel order, for checkpoints trained on BGR inputs
            # (reference: ava_dataset.py:33 _use_bgr)
            out = out[..., ::-1]
        return out

    def getitem_into(self, index: int, frames_out: np.ndarray) -> dict:
        """The item of ``index`` with its canvas pasted into
        ``frames_out`` (T, S, 2S, 3); returns every other field."""
        cfg = self.cfg
        video_idx, sec_idx, sec, center_idx = self._keyframe_indices[index]
        entries = self._keyframe_boxes_and_labels[video_idx][sec_idx]
        frames = self._load_frames(
            video_idx, self._frame_window(video_idx, center_idx))
        short = self._short_side()
        # keep_portrait=False: the boxes are in canvas pixels and the
        # detection preprocess has no transpose stage
        width, _ = fit_canvas_into(frames, short, frames_out)

        boxes = np.array([e[0] for e in entries], np.float32).reshape(-1, 4)
        ori_boxes = boxes.copy()
        # normalized → canvas pixels (the content is width × short)
        px = boxes.copy()
        px[:, [0, 2]] *= width
        px[:, [1, 3]] *= short
        if self._split != "train" and cfg.AVA.TEST_FORCE_FLIP:
            # eval frames and boxes mirrored, for checkpoints trained on
            # flipped data (reference: ava_dataset.py:154-171)
            frames_out[:, :, :width] = frames_out[:, :, :width][:, :, ::-1]
            x1 = width - 1.0 - px[:, 2]
            x2 = width - 1.0 - px[:, 0]
            px[:, 0], px[:, 2] = x1, x2

        labels = np.zeros((MAX_BOXES, self._num_classes), np.float32)
        boxes_out = np.zeros((MAX_BOXES, 4), np.float32)
        mask = np.zeros((MAX_BOXES,), np.float32)
        ori_out = np.zeros((MAX_BOXES, 4), np.float32)
        n = min(len(entries), MAX_BOXES)
        for i in range(n):
            boxes_out[i] = px[i]
            ori_out[i] = ori_boxes[i]
            mask[i] = 1.0
            for label in entries[i][1]:
                if label == -1:
                    continue
                assert 1 <= label <= 80, f"AVA label {label} out of range"
                labels[i][label - 1] = 1.0
        return {
            "width": np.int32(width),
            "boxes": boxes_out,
            "ori_boxes": ori_out,
            "box_labels": labels,
            "box_mask": mask,
            "metadata": np.array([video_idx, sec], np.int64),
            "index": np.int64(index),
            "label": np.int64(0),
            "spatial_idx": np.int32(1),
            "temporal_idx": np.int32(0),
        }

    def __getitem__(self, index: int):
        frames = np.empty(self.frames_shape(), np.uint8)
        return {"frames": frames, **self.getitem_into(index, frames)}
