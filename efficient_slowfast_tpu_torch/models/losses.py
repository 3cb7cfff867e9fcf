"""Loss functions (port of ``models/losses.py:13-73``; reference:
slowfast/models/losses.py:12-28).

Functional: (logits or probabilities, labels) → scalar mean loss, computed
in float32 whatever the input's dtype. ``bce``/``bce_logit`` take multi-hot
float labels (Charades-style multi-label).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_BCE_EPS = 1e-7


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy: integer labels (B,), or soft labels of the
    logits' shape."""
    logp = F.log_softmax(logits.float(), dim=-1)
    if labels.dim() == logits.dim():  # soft labels
        return -(labels.float() * logp).sum(-1).mean()
    return -logp.gather(-1, labels.long()[..., None]).mean()


def bce_elementwise(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Unreduced :func:`bce` — same values, no mean (for masked reductions)."""
    p = torch.clamp(probs.float(), _BCE_EPS, 1.0 - _BCE_EPS)
    y = labels.float()
    return -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))


def bce(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on probabilities (torch nn.BCELoss), the
    probabilities clipped to [1e-7, 1 - 1e-7]."""
    return bce_elementwise(probs, labels).mean()


def bce_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sigmoid binary cross-entropy on logits."""
    x, y = logits.float(), labels.float()
    return -(y * F.logsigmoid(x) + (1.0 - y) * F.logsigmoid(-x)).mean()


_LOSSES = {
    "cross_entropy": cross_entropy,
    "bce": bce,
    "bce_logit": bce_logit,
}

# Unreduced variants for per-sample masking (detection's padded-box mean).
# "bce_logit" is deliberately absent: the RoI head applies MODEL.HEAD_ACT in
# train AND eval (reference head_helper.py:126-129), so detection preds are
# already probabilities — a with-logits loss would silently compute
# sigmoid(sigmoid(x)). Configs asking for it raise instead.
_ELEMENTWISE_LOSSES = {
    "bce": bce_elementwise,
}


def get_loss_func(name: str):
    if name not in _LOSSES:
        raise NotImplementedError(f"Loss {name} is not supported")
    return _LOSSES[name]


def get_elementwise_loss_func(name: str):
    """Loss as (preds, labels) → per-element values (no reduction), for a
    padding mask to weight; only the multi-label losses make sense there."""
    if name not in _ELEMENTWISE_LOSSES:
        raise NotImplementedError(
            f"Loss {name} is not supported for masked per-box training "
            f"(detection); use one of {sorted(_ELEMENTWISE_LOSSES)}")
    return _ELEMENTWISE_LOSSES[name]
