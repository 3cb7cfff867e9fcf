"""Accuracy metrics (port of ``utils/metrics.py:12-35``; reference:
slowfast/utils/metrics.py:9-66).

On the device, with no host sync: counts are tensors. Ties take the JAX
package's order, a stable sort of -preds (the lower class index first),
not ``torch.topk``'s.
"""

from __future__ import annotations

import torch


def topks_correct_per_sample(preds: torch.Tensor, labels: torch.Tensor,
                             ks) -> list:
    """Per-sample top-k correctness, one float32 (B,) vector per k."""
    max_k = max(ks)
    topk_inds = torch.argsort(-preds, dim=-1, stable=True)[:, :max_k]
    correct = topk_inds == labels[:, None]
    return [correct[:, :k].any(dim=-1).float() for k in ks]


def topks_correct(preds: torch.Tensor, labels: torch.Tensor, ks) -> list:
    """Number of top-k-correct predictions for each k."""
    return [c.sum() for c in topks_correct_per_sample(preds, labels, ks)]


def topk_errors(preds, labels, ks):
    num = preds.shape[0]
    return [(1.0 - c / num) * 100.0 for c in topks_correct(preds, labels, ks)]


def topk_accuracies(preds, labels, ks):
    num = preds.shape[0]
    return [(c / num) * 100.0 for c in topks_correct(preds, labels, ks)]
