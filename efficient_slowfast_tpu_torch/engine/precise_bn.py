"""Precise BN: the BN running statistics recomputed over N batches (port of
``engine/precise_bn.py``; reference: fvcore's update_bn_stats through
tools/train_net.py:277-296).

The model runs in train mode over the batches, with no update to its
parameters, and each BN's running statistics become the plain mean of the
batches' statistics. Each forward starts from the same frozen statistics
S and leaves S' = (1-m)·S + m·B, so the batch statistic is recovered as
B = (S' - (1-m)·S) / m, as the JAX package computes it.
"""

from __future__ import annotations

import torch

from ..data.loader import prefetch_to_device
from ..models.build import get_compute_dtype
from .state import _model_device, step_generator


def calculate_and_update_precise_bn(cfg, state, loader, preprocess,
                                    num_batches: int):
    """Set ``state.model``'s BN running statistics to their mean over the
    first ``num_batches`` batches of ``loader``, each preprocessed by
    ``preprocess`` with the i-th batch's generator
    (``step_generator(RNG_SEED, i)``, which also draws the head's dropout).
    The step counters of the BNs are left as they were. Returns the state."""
    model = state.model
    dev = _model_device(state)
    dtype = get_compute_dtype(cfg)
    m = cfg.BN.MOMENTUM
    stats = {k: v for k, v in model.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    counts = {k: v.clone() for k, v in model.named_buffers()
              if k.endswith("num_batches_tracked")}
    frozen = {k: v.clone() for k, v in stats.items()}
    total = {k: torch.zeros_like(v) for k, v in stats.items()}
    seen = 0
    model.train()
    batches = prefetch_to_device(loader, dev,
                                 depth=cfg.DATA_LOADER.PREFETCH_DEPTH)
    try:
        with torch.no_grad():
            for i, batch in zip(range(num_batches), batches):
                gen = step_generator(cfg.RNG_SEED, i, dev)
                inputs = preprocess(gen, batch["frames"], batch["width"],
                                    batch.get("portrait"), batch.get("crop_u"))
                for k, v in stats.items():
                    v.copy_(frozen[k])
                model([x.to(dev, dtype) for x in inputs], generator=gen)
                for k, v in stats.items():
                    total[k] += (v - (1.0 - m) * frozen[k]) / m
                seen += 1
            for k, v in stats.items():
                v.copy_(total[k] / seen if seen else frozen[k])
            for k, v in model.named_buffers():
                if k in counts:
                    v.copy_(counts[k])
    finally:
        batches.close()
    return state
