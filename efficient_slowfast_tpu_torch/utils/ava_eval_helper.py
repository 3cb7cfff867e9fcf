"""AVA evaluation harness (port of ``utils/ava_eval_helper.py``;
reference: slowfast/utils/ava_eval_helper.py).

CSV/pbtxt readers (:48-125) and the end-to-end evaluation entry
(evaluate_ava → run_evaluation, :136-248) on top of the numpy evaluator in
utils/ava_evaluation.py. Image keys are "video,timestamp%04d"; excluded
keyframes are dropped from both GT and detections.
"""

from __future__ import annotations

import csv
import time
from collections import defaultdict
from typing import List, Optional, Set, Tuple

import numpy as np

from .ava_evaluation import PascalDetectionEvaluator
from .logging import get_logger

logger = get_logger(__name__)


def make_image_key(video_id: str, timestamp) -> str:
    return f"{video_id},{int(timestamp):04d}"


def read_csv(csv_file: str, class_whitelist: Optional[Set[int]] = None):
    """AVA csv: video_id, timestamp, x1, y1, x2, y2, action_id[, score].

    Returns (boxes, labels, scores) dicts keyed by image key; box coords are
    stored [y1, x1, y2, x2] like the reference reader (:48-86).
    """
    boxes = defaultdict(list)
    labels = defaultdict(list)
    scores = defaultdict(list)
    with open(csv_file, "r") as f:
        reader = csv.reader(f)
        for row in reader:
            if not row:
                continue
            assert len(row) in (7, 8), f"Wrong number of columns: {row}"
            key = make_image_key(row[0], row[1])
            x1, y1, x2, y2 = (float(n) for n in row[2:6])
            action_id = int(row[6])
            if class_whitelist and action_id not in class_whitelist:
                continue
            score = float(row[7]) if len(row) == 8 else 1.0
            boxes[key].append([y1, x1, y2, x2])
            labels[key].append(action_id)
            scores[key].append(score)
    return boxes, labels, scores


def read_exclusions(exclusions_file: Optional[str]) -> Set[str]:
    excluded = set()
    if exclusions_file:
        with open(exclusions_file, "r") as f:
            for row in csv.reader(f):
                assert len(row) == 2, f"Expected only 2 columns, got: {row}"
                excluded.add(make_image_key(row[0], row[1]))
    return excluded


def read_labelmap(labelmap_file: str) -> Tuple[List[dict], Set[int]]:
    """Minimal pbtxt parse: name: "..." / id: N pairs (reference :102-125)."""
    labelmap = []
    class_ids = set()
    name = ""
    with open(labelmap_file, "r") as f:
        for line in f:
            if line.startswith("  name:"):
                name = line.split('"')[1]
            elif line.startswith("  id:") or line.startswith("  label_id:"):
                class_id = int(line.strip().split(" ")[-1])
                labelmap.append({"id": class_id, "name": name})
                class_ids.add(class_id)
    return labelmap, class_ids


def evaluate_ava(
    preds: np.ndarray,            # (num_boxes, num_classes) scores
    original_boxes: np.ndarray,   # (num_boxes, 5) [batch_idx, x1, y1, x2, y2]
    metadata: np.ndarray,         # (num_boxes, 2) [video_idx, sec]
    excluded_keys: Set[str],
    class_whitelist: Set[int],
    categories: List[dict],
    groundtruth=None,             # (boxes, labels, scores) dicts
    video_idx_to_name: Optional[List[str]] = None,
    name: str = "latest",
) -> float:
    """Full-dataset mAP (reference :136-207). Detections get every whitelisted
    class with its score attached to each box."""
    eval_start = time.time()
    detections = get_ava_eval_data(
        preds, original_boxes, metadata, class_whitelist,
        video_idx_to_name=video_idx_to_name,
    )
    logger.info("Evaluating with %d unique GT frames", len(groundtruth[0]))
    logger.info("Evaluating with %d unique detection frames", len(detections[0]))
    result = run_evaluation(categories, groundtruth, detections, excluded_keys)
    mAP = result["PascalBoxes_Precision/mAP@0.5IOU"]
    logger.info("AVA eval done in %.2f seconds.", time.time() - eval_start)
    logger.info("AVA mAP (%s): %.4f", name, mAP)
    return float(mAP)


def get_ava_eval_data(scores, boxes, metadata, class_whitelist,
                      video_idx_to_name=None):
    """Flatten model outputs into per-keyframe detection dicts
    (reference :210-248). Box coords arrive normalized [x1,y1,x2,y2]."""
    out_boxes = defaultdict(list)
    out_labels = defaultdict(list)
    out_scores = defaultdict(list)
    for i in range(scores.shape[0]):
        video_idx = int(metadata[i][0])
        sec = int(metadata[i][1])
        video = (video_idx_to_name[video_idx] if video_idx_to_name
                 else str(video_idx))
        key = make_image_key(video, sec)
        x1, y1, x2, y2 = boxes[i][1:5]
        for cls, score in enumerate(scores[i]):
            cls_idx = cls + 1  # AVA labels are 1-based
            if cls_idx in class_whitelist:
                out_boxes[key].append([y1, x1, y2, x2])
                out_labels[key].append(cls_idx)
                out_scores[key].append(float(score))
    return out_boxes, out_labels, out_scores


def run_evaluation(categories, groundtruth, detections, excluded_keys):
    """reference :136-207: feed evaluator, skipping excluded keyframes."""
    evaluator = PascalDetectionEvaluator(categories)
    gt_boxes, gt_labels, _ = groundtruth
    for key in gt_boxes:
        if key in excluded_keys:
            logger.info("Excluded GT keyframe: %s", key)
            continue
        evaluator.add_single_ground_truth_image_info(key, {
            "boxes": np.array(gt_boxes[key], dtype=float),
            "classes": np.array(gt_labels[key], dtype=int),
        })
    det_boxes, det_labels, det_scores = detections
    for key in det_boxes:
        if key in excluded_keys:
            logger.info("Excluded detection keyframe: %s", key)
            continue
        evaluator.add_single_detected_image_info(key, {
            "boxes": np.array(det_boxes[key], dtype=float),
            "classes": np.array(det_labels[key], dtype=int),
            "scores": np.array(det_scores[key], dtype=float),
        })
    return evaluator.evaluate()
