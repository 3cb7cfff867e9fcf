"""Data-loading benchmark (port of ``utils/benchmark.py``; reference:
slowfast/utils/benchmark.py:20-103).

Times the host pipeline alone (list, read, decode, canvas paste, collate)
over the train split's loader, with no device work, logging each window's
clips/s and host memory (``benchmark_iter``), each epoch's seconds
(``benchmark_epoch``) and their mean (``benchmark_final``)."""

from __future__ import annotations

import time

import numpy as np

from ..data.loader import construct_loader, shuffle_dataset
from .logging import log_json_stats, setup_logging
from .misc import cpu_mem_usage


def benchmark_data_loading(cfg):
    """BENCHMARK.NUM_EPOCHS epochs of the train loader; returns each
    epoch's seconds."""
    setup_logging(cfg.OUTPUT_DIR)
    loader = construct_loader(cfg, "train")
    total = len(loader)
    log_period = cfg.BENCHMARK.LOG_PERIOD
    epoch_times = []
    for epoch in range(cfg.BENCHMARK.NUM_EPOCHS):
        if cfg.BENCHMARK.SHUFFLE:
            shuffle_dataset(loader, epoch)
        t_epoch = t_win = time.perf_counter()
        clips = 0
        for cur_iter, batch in enumerate(loader):
            clips += batch["frames"].shape[0]
            if (cur_iter + 1) % log_period == 0:
                dt = time.perf_counter() - t_win
                used, _ = cpu_mem_usage()
                log_json_stats({
                    "_type": "benchmark_iter",
                    "epoch": epoch + 1,
                    "iter": f"{cur_iter + 1}/{total}",
                    "clips_per_s": clips / dt,
                    "ram_gb": round(used, 2),
                })
                clips = 0
                t_win = time.perf_counter()
        epoch_times.append(time.perf_counter() - t_epoch)
        log_json_stats({
            "_type": "benchmark_epoch",
            "epoch": epoch + 1,
            "epoch_time_s": round(epoch_times[-1], 2),
        })
    log_json_stats({
        "_type": "benchmark_final",
        "mean_epoch_time_s": round(float(np.mean(epoch_times)), 2),
    })
    return epoch_times
