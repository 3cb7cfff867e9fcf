"""Meters (port of ``utils/meters.py:20-300``; reference:
slowfast/utils/meters.py).

ScalarMeter (:375-423), TrainMeter (:426-554), ValMeter (:557-687) and
TestMeter (:216-372, per-video clip-score ensembling). Values arrive as
numpy arrays and Python floats: the engines read the device back once per
``TPU.METRICS_PERIOD`` steps, never inside a meter. ``StageTimes`` adds
per-batch stage times for measurement. ``AVAMeter`` (:316-412) runs AVA's
frame mAP; ``get_map`` (:302-313) is the multi-label test's mean average
precision, in numpy.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from .logging import log_json_stats


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._paused: Optional[float] = None
        self._total = 0.0

    def pause(self):
        if self._paused is None:
            self._paused = time.perf_counter()

    def resume(self):
        if self._paused is not None:
            self._total += self._paused - self._start
            self._start = time.perf_counter()
            self._paused = None

    def seconds(self) -> float:
        if self._paused is not None:
            return self._total + (self._paused - self._start)
        return self._total + (time.perf_counter() - self._start)


class ScalarMeter:
    """Windowed scalar tracker (median/avg over a deque)."""

    def __init__(self, window_size: int):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def reset(self):
        self.deque.clear()
        self.total = 0.0
        self.count = 0

    def add_value(self, value: float):
        self.deque.append(value)
        self.count += 1
        self.total += value

    def get_win_median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    def get_win_avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    def get_global_avg(self) -> float:
        return self.total / max(self.count, 1)


def _eta(seconds_per_iter: float, iters_left: int) -> str:
    return str(datetime.timedelta(seconds=int(seconds_per_iter * iters_left)))


class TrainMeter:
    def __init__(self, epoch_iters: int, cfg):
        self._cfg = cfg
        self.epoch_iters = epoch_iters
        self.MAX_EPOCH = cfg.SOLVER.MAX_EPOCH * epoch_iters
        self.iter_timer = Timer()
        self.loss = ScalarMeter(cfg.LOG_PERIOD)
        self.loss_total = 0.0
        self.lr = None
        self.mb_top1_err = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top_k_err = ScalarMeter(cfg.LOG_PERIOD)
        self.num_top1_mis = 0
        self.num_top_k_mis = 0
        self.num_samples = 0

    def reset(self):
        self.loss.reset()
        self.loss_total = 0.0
        self.lr = None
        self.mb_top1_err.reset()
        self.mb_top_k_err.reset()
        self.num_top1_mis = 0
        self.num_top_k_mis = 0
        self.num_samples = 0

    def iter_tic(self):
        self.iter_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def update_stats(self, top1_err, top_k_err, loss, lr, mb_size):
        self.loss.add_value(loss)
        self.lr = lr
        self.loss_total += loss * mb_size
        self.num_samples += mb_size
        if top1_err is not None:
            self.mb_top1_err.add_value(top1_err)
            self.mb_top_k_err.add_value(top_k_err)
            self.num_top1_mis += top1_err * mb_size
            self.num_top_k_mis += top_k_err * mb_size

    def log_iter_stats(self, cur_epoch, cur_iter):
        if (cur_iter + 1) % self._cfg.LOG_PERIOD != 0:
            return
        sec = self.iter_timer.seconds() / max(cur_iter + 1, 1)
        stats = {
            "_type": "train_iter",
            "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "time_diff": sec,
            "eta": _eta(sec, self.MAX_EPOCH - (cur_epoch * self.epoch_iters + cur_iter + 1)),
            "loss": self.loss.get_win_median(),
            "lr": self.lr,
        }
        if self.mb_top1_err.count:
            stats["top1_err"] = self.mb_top1_err.get_win_median()
            stats["top_k_err"] = self.mb_top_k_err.get_win_median()
        log_json_stats(stats)

    def log_epoch_stats(self, cur_epoch):
        sec = self.iter_timer.seconds() / max(self.epoch_iters, 1)
        stats = {
            "_type": "train_epoch",
            "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
            "time_diff": sec,
            "eta": _eta(sec, self.MAX_EPOCH - (cur_epoch + 1) * self.epoch_iters),
            "lr": self.lr,
            "loss": self.loss_total / max(self.num_samples, 1),
        }
        if self.num_samples:
            stats["top1_err"] = self.num_top1_mis / self.num_samples
            stats["top_k_err"] = self.num_top_k_mis / self.num_samples
        log_json_stats(stats)


class ValMeter:
    def __init__(self, max_iter: int, cfg):
        self._cfg = cfg
        self.max_iter = max_iter
        self.iter_timer = Timer()
        self.mb_top1_err = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top_k_err = ScalarMeter(cfg.LOG_PERIOD)
        self.min_top1_err = 100.0
        self.min_top_k_err = 100.0
        self.num_top1_mis = 0
        self.num_top_k_mis = 0
        self.num_samples = 0

    def reset(self):
        self.iter_timer.reset()
        self.mb_top1_err.reset()
        self.mb_top_k_err.reset()
        self.num_top1_mis = 0
        self.num_top_k_mis = 0
        self.num_samples = 0

    def iter_tic(self):
        self.iter_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def update_stats(self, top1_err, top_k_err, mb_size):
        self.mb_top1_err.add_value(top1_err)
        self.mb_top_k_err.add_value(top_k_err)
        self.num_top1_mis += top1_err * mb_size
        self.num_top_k_mis += top_k_err * mb_size
        self.num_samples += mb_size

    def log_iter_stats(self, cur_epoch, cur_iter):
        if (cur_iter + 1) % self._cfg.LOG_PERIOD != 0:
            return
        log_json_stats({
            "_type": "val_iter",
            "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.max_iter}",
            "top1_err": self.mb_top1_err.get_win_median(),
            "top_k_err": self.mb_top_k_err.get_win_median(),
        })

    def log_epoch_stats(self, cur_epoch):
        top1 = self.num_top1_mis / max(self.num_samples, 1)
        topk = self.num_top_k_mis / max(self.num_samples, 1)
        self.min_top1_err = min(self.min_top1_err, top1)
        self.min_top_k_err = min(self.min_top_k_err, topk)
        log_json_stats({
            "_type": "val_epoch",
            "epoch": f"{cur_epoch + 1}/{self._cfg.SOLVER.MAX_EPOCH}",
            "top1_err": top1,
            "top_k_err": topk,
            "min_top1_err": self.min_top1_err,
            "min_top_k_err": self.min_top_k_err,
        })
        return top1


class TestMeter:
    """Multi-view test ensembling (reference: meters.py:216-372).

    Accumulates per-video clip scores (sum or max over the
    NUM_ENSEMBLE_VIEWS × NUM_SPATIAL_CROPS views) and verifies every video
    received all its clips before computing final top-k accuracies.
    """

    def __init__(self, num_videos, num_clips, num_cls, overall_iters,
                 multi_label=False, ensemble_method="sum", topk=5):
        assert ensemble_method in ("sum", "max")
        self.num_clips = num_clips
        self.overall_iters = overall_iters
        self.multi_label = multi_label
        self.ensemble_method = ensemble_method
        self.topk = topk
        self.iter_timer = Timer()
        self.video_preds = np.zeros((num_videos, num_cls), np.float64)
        if multi_label:
            self.video_preds -= 1e10
        self.video_labels = np.zeros(
            (num_videos, num_cls) if multi_label else (num_videos,), np.int64
        )
        self.clip_count = np.zeros((num_videos,), np.int64)
        self.stats = {}

    def reset(self):
        self.clip_count[:] = 0
        self.video_preds[:] = -1e10 if self.multi_label else 0
        self.video_labels[:] = 0

    def iter_tic(self):
        self.iter_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def update_stats(self, preds, labels, clip_ids):
        for ind in range(preds.shape[0]):
            vid_id = int(clip_ids[ind]) // self.num_clips
            if self.video_labels[vid_id].sum() > 0:
                assert np.array_equal(
                    self.video_labels[vid_id], np.asarray(labels[ind])
                ), "label mismatch across clips of one video"
            self.video_labels[vid_id] = labels[ind]
            if self.ensemble_method == "sum":
                self.video_preds[vid_id] += preds[ind]
            else:
                self.video_preds[vid_id] = np.maximum(
                    self.video_preds[vid_id], preds[ind]
                )
            self.clip_count[vid_id] += 1

    def log_iter_stats(self, cur_iter):
        log_json_stats({
            "_type": "test_iter",
            "cur_iter": f"{cur_iter + 1}",
            "time_diff": self.iter_timer.seconds(),
        })

    def finalize_metrics(self, ks=(1, 5)) -> Dict[str, float]:
        if not np.all(self.clip_count == self.num_clips):
            # The reference only warns here (meters.py:340-351); we raise —
            # a silently-partial ensemble is a wrong top-1, not a degraded one.
            bad = np.argwhere(self.clip_count != self.num_clips).flatten()
            raise RuntimeError(
                "test ensemble incomplete: {} of {} videos missing clips "
                "(expected {} clips/video; e.g. {})".format(
                    len(bad), self.clip_count.shape[0], self.num_clips,
                    ", ".join(
                        f"video {i}: {self.clip_count[i]}" for i in bad[:10]
                    ),
                )
            )
        stats = {"_type": "test_final"}
        if self.multi_label:
            stats["map"] = get_map(self.video_preds, self.video_labels)
        else:
            order = np.argsort(-self.video_preds, axis=1)
            for k in ks:
                correct = (order[:, :k] == self.video_labels[:, None]).any(1)
                stats[f"top{k}_acc"] = f"{100.0 * correct.mean():.2f}"
        log_json_stats(stats)
        self.stats = stats
        return stats


def _average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    """One class's average precision without interpolation: Σ_k (R_k −
    R_{k−1}) P_k over the distinct score thresholds, high to low (tied
    scores are one threshold); sklearn's ``average_precision_score``
    computed its way."""
    order = np.argsort(scores, kind="mergesort")[::-1]
    scores, labels = scores[order], labels[order]
    idx = np.r_[np.nonzero(np.diff(scores))[0], labels.size - 1]
    tps = np.cumsum(labels == 1, dtype=np.float64)[idx]
    fps = 1 + idx - tps
    ps = tps + fps
    precision = np.zeros_like(tps)
    np.divide(tps, ps, out=precision, where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def get_map(preds: np.ndarray, labels: np.ndarray) -> float:
    """Mean average precision over classes (reference: meters.py:690-714),
    the classes with no positive label left out. Where sklearn's
    ``average_precision_score`` refuses its input (no sample or class
    left, a non-finite score or label, a label other than 0 and 1), the
    mean is 0.0, as the JAX package returns then."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    keep = ~np.all(labels == 0, axis=0)
    preds, labels = preds[:, keep], labels[:, keep]
    if (preds.size == 0 or not np.all(np.isfinite(preds))
            or not np.all(np.isin(labels, (0, 1)))):
        return 0.0
    return float(np.mean([_average_precision(labels[:, j], preds[:, j])
                          for j in range(labels.shape[1])]))


class AVAMeter:
    """Detection meter running the full AVA mAP evaluation (reference:
    meters.py:46-213): it gathers post-sigmoid box scores, the original
    normalized boxes and (video index, second) metadata, and runs the
    numpy evaluator at ``finalize_metrics``."""

    def __init__(self, overall_iters, cfg, mode: str):
        from .ava_eval_helper import read_csv, read_exclusions, read_labelmap

        self.cfg = cfg
        self.mode = mode
        self.overall_iters = overall_iters
        self.iter_timer = Timer()
        self.loss = ScalarMeter(cfg.LOG_PERIOD)
        self.lr = None
        self.all_preds = []
        self.all_ori_boxes = []
        self.all_metadata = []
        self.full_map = float("nan")
        self.stats = {}
        ann = cfg.AVA.ANNOTATION_DIR
        self.excluded_keys = read_exclusions(
            os.path.join(ann, cfg.AVA.EXCLUSION_FILE)
            if cfg.AVA.EXCLUSION_FILE else None)
        self.categories, self.class_whitelist = read_labelmap(
            os.path.join(ann, cfg.AVA.LABEL_MAP_FILE))
        self.full_groundtruth = read_csv(
            os.path.join(ann, cfg.AVA.GROUNDTRUTH_FILE), self.class_whitelist)
        self.video_idx_to_name = None  # set by the engine

    def reset(self):
        self.all_preds = []
        self.all_ori_boxes = []
        self.all_metadata = []

    def iter_tic(self):
        self.iter_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()

    def update_stats(self, preds, ori_boxes, metadata, loss=None, lr=None):
        if self.mode in ("val", "test"):
            self.all_preds.append(np.asarray(preds))
            self.all_ori_boxes.append(np.asarray(ori_boxes))
            self.all_metadata.append(np.asarray(metadata))
        if loss is not None:
            self.loss.add_value(float(loss))
        if lr is not None:
            self.lr = lr

    def log_iter_stats(self, cur_epoch, cur_iter):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        stats = {
            "_type": f"{self.mode}_iter",
            "cur_epoch": str(cur_epoch + 1) if cur_epoch is not None else "",
            "cur_iter": f"{cur_iter + 1}",
            "time_diff": self.iter_timer.seconds(),
            "mode": self.mode,
        }
        if self.mode == "train":
            stats["loss"] = self.loss.get_win_median()
            stats["lr"] = self.lr
        log_json_stats(stats)

    def finalize_metrics(self, log: bool = True) -> float:
        from .ava_eval_helper import evaluate_ava

        if not self.all_preds:
            return float("nan")
        self.full_map = evaluate_ava(
            np.concatenate(self.all_preds, axis=0),
            np.concatenate(self.all_ori_boxes, axis=0),
            np.concatenate(self.all_metadata, axis=0),
            self.excluded_keys, self.class_whitelist, self.categories,
            groundtruth=self.full_groundtruth,
            video_idx_to_name=self.video_idx_to_name)
        self.stats = {"_type": f"{self.mode}_final", "mode": self.mode,
                      "map": self.full_map}
        if log:
            log_json_stats(self.stats)
        return self.full_map

    def log_epoch_stats(self, cur_epoch):
        if self.mode in ("val", "test"):
            self.finalize_metrics(log=False)
            log_json_stats({
                "_type": f"{self.mode}_epoch",
                "cur_epoch": str(cur_epoch + 1),
                "mode": self.mode,
                "map": self.full_map,
            })
            return self.full_map


def span(times: Optional["StageTimes"], name, device, stream=None):
    """``times.span(...)``, or nothing where no StageTimes is given."""
    if times is None:
        return contextlib.nullcontext()
    return times.span(name, device, stream)


class StageTimes:
    """Per-batch times of an engine loop's stages, for measurement.

    ``waits`` holds the host seconds the loop spent waiting on its loader;
    ``span(name, device, stream)`` brackets one stage of one batch. On a
    CUDA device a span is a pair of CUDA events recorded on ``stream`` (the
    current one by default), read only by ``summary()`` after the loop, so
    recording adds no synchronisation; on the CPU it is the host clock.
    """

    def __init__(self):
        self.waits = []
        self._spans: Dict[str, list] = {}

    @contextlib.contextmanager
    def span(self, name, device, stream=None):
        spans = self._spans.setdefault(name, [])
        if torch.device(device).type != "cuda":
            t0 = time.perf_counter()
            yield
            spans.append((time.perf_counter() - t0) * 1e3)
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end.record(stream)
        spans.append((start, end))

    def summary(self) -> Dict[str, list]:
        """{stage: [ms per batch]}, with ``wait`` in host milliseconds."""
        out = {"wait": [s * 1e3 for s in self.waits]}
        for name, spans in self._spans.items():
            out[name] = [s if isinstance(s, float) else
                         (s[1].synchronize(), s[0].elapsed_time(s[1]))[1]
                         for s in spans]
        return out
