"""Frame-level mAP evaluation for AVA-style detection (port of
``utils/ava_evaluation.py``).

Fresh numpy implementation of the PASCAL-VOC-style per-class average
precision used by the AVA protocol (functional equivalent of the reference's
vendored TF object-detection evaluator, slowfast/utils/ava_evaluation/ —
object_detection_evaluation.py, per_image_evaluation.py, metrics.py,
np_box_ops.py): per class, detections are greedily matched to unmatched
groundtruth boxes at IoU ≥ threshold; AP is the area under the interpolated
precision-recall curve over the score-sorted detections; mAP averages
classes that have groundtruth.

Parity quirk, matched deliberately: the reference's vendored evaluator
dropped the TF OD API's NMS stage (which score-sorts detections before
matching), so its per-image greedy matching runs in detection INSERTION
order, not score order (reference per_image_evaluation.py
`_get_overlaps_and_scores_box_mode` — no sort; the matching loop iterates
`range(num_detected_boxes)`). We reproduce that: matching is insertion-
ordered per image; only the PR curve is score-sorted. The JAX package's
copy is cross-validated against the reference evaluator
(tests/test_ava_evaluation.py), and this one against that copy.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import numpy as np


def box_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """IoU matrix for [x1, y1, x2, y2] boxes: (N, 4) × (M, 4) → (N, M)."""
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.zeros((len(boxes1), len(boxes2)))
    area1 = np.maximum(boxes1[:, 2] - boxes1[:, 0], 0) * np.maximum(
        boxes1[:, 3] - boxes1[:, 1], 0)
    area2 = np.maximum(boxes2[:, 2] - boxes2[:, 0], 0) * np.maximum(
        boxes2[:, 3] - boxes2[:, 1], 0)
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def average_precision(precision: np.ndarray, recall: np.ndarray) -> float:
    """Interpolated AP (area under the PR envelope), VOC-2010 style."""
    if precision is None or len(precision) == 0:
        return float("nan")
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class PascalDetectionEvaluator:
    """Accumulates per-image GT/detections, emits per-class AP + mAP."""

    def __init__(self, categories: Iterable[dict], iou_threshold: float = 0.5):
        self._classes = [int(c["id"]) for c in categories]
        self._names = {int(c["id"]): c.get("name", str(c["id"]))
                       for c in categories}
        self.iou = iou_threshold
        # class → list of (image, box)
        self._gt: Dict[int, Dict[str, np.ndarray]] = defaultdict(dict)
        self._gt_count: Dict[int, int] = defaultdict(int)
        # class → list of (score, image, box)
        self._det: Dict[int, List[Tuple[float, str, np.ndarray]]] = defaultdict(list)

    def add_single_ground_truth_image_info(self, image_key: str, info: dict):
        boxes = np.asarray(info["boxes"], np.float64).reshape(-1, 4)
        classes = np.asarray(info["classes"], np.int64).reshape(-1)
        for cls in self._classes:
            sel = boxes[classes == cls]
            if len(sel):
                self._gt[cls][image_key] = sel
                self._gt_count[cls] += len(sel)

    def add_single_detected_image_info(self, image_key: str, info: dict):
        boxes = np.asarray(info["boxes"], np.float64).reshape(-1, 4)
        classes = np.asarray(info["classes"], np.int64).reshape(-1)
        scores = np.asarray(info["scores"], np.float64).reshape(-1)
        for b, c, s in zip(boxes, classes, scores):
            if c in self._names:
                self._det[int(c)].append((float(s), image_key, b))

    def evaluate(self) -> Dict[str, float]:
        aps = {}
        for cls in self._classes:
            npos = self._gt_count[cls]
            if npos == 0:
                continue
            # stage 1 — greedy matching in INSERTION order per image (the
            # reference's semantics, see module docstring)
            matched: Dict[str, np.ndarray] = {
                k: np.zeros(len(v), bool) for k, v in self._gt[cls].items()
            }
            scored = []  # (score, is_tp)
            for score, img, box in self._det[cls]:
                gt = self._gt[cls].get(img)
                if gt is None or len(gt) == 0:
                    scored.append((score, 0.0))
                    continue
                ious = box_iou(box[None], gt)[0]
                j = int(np.argmax(ious))
                if ious[j] >= self.iou and not matched[img][j]:
                    scored.append((score, 1.0))
                    matched[img][j] = True
                else:
                    scored.append((score, 0.0))
            # stage 2 — PR curve over score-sorted detections. Deliberate
            # tie-order deviation from the reference: this stable descending
            # sort keeps insertion order on equal scores, while the
            # reference's argsort()[::-1] (ava_evaluation/metrics.py:60)
            # REVERSES it — AP can differ in the last decimals when
            # detection scores tie exactly (real detector scores never do;
            # the cross-validation fixture uses distinct scores).
            scored.sort(key=lambda t: -t[0])
            tp = np.asarray([s[1] for s in scored])
            ctp = np.cumsum(tp)
            cfp = np.cumsum(1.0 - tp)
            recall = ctp / npos
            precision = ctp / np.maximum(ctp + cfp, 1e-12)
            aps[cls] = average_precision(precision, recall)
        result = {
            f"PascalBoxes_PerformanceByCategory/AP@{self.iou}IOU/"
            f"{self._names[c]}": ap
            for c, ap in aps.items()
        }
        result[f"PascalBoxes_Precision/mAP@{self.iou}IOU"] = (
            float(np.mean(list(aps.values()))) if aps else float("nan")
        )
        return result
