"""AVA annotation loading (port of ``data/ava_helper.py``; reference:
slowfast/datasets/ava_helper.py).

Frame lists ("original_video_id video_id frame_id path labels''", :15-67)
and box csvs with detection-score threshold (:68-154); ``data/ava_dataset``
takes the 1-FPS keyframes from them (:155-200). AVA frames are 30 FPS;
keyframes live at seconds [902, 1798] and frame index = (sec - 900) * 30.
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, List, Tuple

from ..utils.logging import get_logger

logger = get_logger(__name__)

FPS = 30
AVA_VALID_FRAMES = range(902, 1799)


def frame_sec_to_idx(sec: int) -> int:
    return (sec - 900) * FPS


def load_image_lists(cfg, is_train: bool) -> Tuple[List[List[str]], Dict[str, int]]:
    """Returns (image_paths[video_idx][frame_idx], video_name→idx)."""
    list_filenames = [
        os.path.join(cfg.AVA.FRAME_LIST_DIR, f)
        for f in (cfg.AVA.TRAIN_LISTS if is_train else cfg.AVA.TEST_LISTS)
    ]
    image_paths = defaultdict(dict)
    video_name_to_idx = {}
    video_idx_to_name = []
    for list_filename in list_filenames:
        with open(list_filename, "r") as f:
            header = f.readline()  # original_vido_id video_id frame_id path labels
            for line in f:
                row = line.split()
                if len(row) < 4:
                    continue
                video_name = row[0]
                if video_name not in video_name_to_idx:
                    idx = len(video_name_to_idx)
                    video_name_to_idx[video_name] = idx
                    video_idx_to_name.append(video_name)
                data_key = video_name_to_idx[video_name]
                image_paths[data_key][int(row[2])] = os.path.join(
                    cfg.AVA.FRAME_DIR, row[3]
                )
    out = []
    for i in range(len(video_name_to_idx)):
        frames = image_paths[i]
        out.append([frames[k] for k in sorted(frames.keys())])
    logger.info("Finished loading image paths from: %s",
                ", ".join(list_filenames))
    return out, video_idx_to_name


def load_boxes_and_labels(cfg, mode: str):
    """Returns all_boxes[video_name][sec] = list of [box(x1y1x2y2 norm), labels]."""
    gt_lists = cfg.AVA.TRAIN_GT_BOX_LISTS if mode == "train" else []
    pred_lists = (
        cfg.AVA.TRAIN_PREDICT_BOX_LISTS if mode == "train"
        else cfg.AVA.TEST_PREDICT_BOX_LISTS
    )
    ann_filenames = [
        os.path.join(cfg.AVA.ANNOTATION_DIR, f) for f in gt_lists + pred_lists
    ]
    ann_is_gt_box = [True] * len(gt_lists) + [False] * len(pred_lists)

    all_boxes: Dict[str, Dict[int, dict]] = {}
    count = 0
    unique_box_count = 0
    thresh = cfg.AVA.DETECTION_SCORE_THRESH
    for filename, is_gt_box in zip(ann_filenames, ann_is_gt_box):
        with open(filename, "r") as f:
            for row in csv.reader(f):
                if not row:
                    continue
                assert len(row) in (7, 8), f"bad AVA csv row: {row}"
                if not is_gt_box and len(row) == 8:
                    score = float(row[7])
                    if score < thresh:
                        continue
                video_name, frame_sec = row[0], int(row[1])
                if frame_sec not in AVA_VALID_FRAMES:
                    continue
                # Validation-during-training evaluates every 4th keyframe
                # second unless AVA.FULL_TEST_ON_VAL; the test split is
                # never subsampled (reference ava_helper.py:110-118).
                if (mode == "val" and not cfg.AVA.FULL_TEST_ON_VAL
                        and frame_sec % 4 != 0):
                    continue
                box_key = ",".join(row[2:6])
                box = list(map(float, row[2:6]))
                label = -1 if row[6] == "" else int(row[6])
                all_boxes.setdefault(video_name, {}).setdefault(frame_sec, {})
                if box_key not in all_boxes[video_name][frame_sec]:
                    all_boxes[video_name][frame_sec][box_key] = [box, []]
                    unique_box_count += 1
                all_boxes[video_name][frame_sec][box_key][1].append(label)
                if label != -1:
                    count += 1
    for video_name in all_boxes:
        for frame_sec in all_boxes[video_name]:
            all_boxes[video_name][frame_sec] = list(
                all_boxes[video_name][frame_sec].values()
            )
    logger.info("Finished loading annotations: %d boxes, %d labels",
                unique_box_count, count)
    return all_boxes


def get_num_boxes_used(keyframe_indices, keyframe_boxes_and_labels) -> int:
    count = 0
    for video_idx, sec_idx, _, _ in keyframe_indices:
        count += len(keyframe_boxes_and_labels[video_idx][sec_idx])
    return count
