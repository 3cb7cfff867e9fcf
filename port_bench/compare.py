"""The numbers that decide ``correct``, and the control's rounding.

Serving: the scores of a sample of the window's clips against the
reference's. A clip's centred log-scores (log p minus their mean over the
classes) are compared, and ``score_gap`` is the widest gap over the
sample's clips and classes, over the standard deviation of that clip's
reference centred log-scores: seeded weights give scores near uniform,
whose spread sets the scale.

Training: the first step's logits (``logit_gap``, ``centred_gap`` of
the model's output), the first gradient (``grad_median_gap``) and the
parameters' change after the checked steps (``update_median_gap``), these
two by the median leaf of the gaps between the program's norm of a leaf and
the reference's, over the reference's. Leaves whose reference gradient is
under a thousandth of the median leaf's are left out: they move by
round-off alone (the key and value convs' biases, under the softmax and
before a train-mode BN). The losses and the worst leaf's gaps are read by
``calibrate.py`` but not compared: PERF.md gives their readings.

``fp8`` rounds a tensor to float8 e4m3 with one scale for the tensor, the
step below the configurations' bfloat16: the reference computed with it in
the program's place is the control, which has to fail.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 (a straight-through gradient)."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


def centred_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """Widest gap of (clips, classes) values centred over the classes, over
    the standard deviation of each clip's centred reference values;
    infinite where an answer is missing."""
    if program.shape != reference.shape:
        return float("inf")
    cp = program.double() - program.double().mean(1, keepdim=True)
    cr = reference.double() - reference.double().mean(1, keepdim=True)
    spread = cr.std(1).clamp(min=1e-30)
    return float(((cp - cr).abs().amax(1) / spread).max())


def score_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """``centred_gap`` of the log-scores of (clips, classes) scores."""
    return centred_gap(program.double().clamp(min=1e-30).log(),
                       reference.double().clamp(min=1e-30).log())


def loss_gap(program, reference) -> float:
    p = torch.tensor(program, dtype=torch.float64)
    r = torch.tensor(reference, dtype=torch.float64)
    return float(((p - r).abs() / r.abs()).max())


def kept_leaves(ref_grad_norms: dict) -> list:
    norms = torch.tensor(list(ref_grad_norms.values()), dtype=torch.float64)
    floor = 1e-3 * float(norms.median())
    return [n for n, v in ref_grad_norms.items() if v >= floor]


def leaf_gaps(program: dict, reference: dict, leaves: list) -> dict:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    ref = torch.tensor([reference[n] for n in leaves], dtype=torch.float64)
    prog = torch.tensor([program[n] for n in leaves], dtype=torch.float64)
    gaps = (prog - ref).abs() / torch.maximum(ref, ref.median())
    return dict(zip(leaves, gaps.tolist()))


def median_gap(program: dict, reference: dict, leaves: list) -> float:
    """The median over the leaves of the gap of norms over the reference's
    norm of that leaf."""
    ref = torch.tensor([reference[n] for n in leaves], dtype=torch.float64)
    prog = torch.tensor([program[n] for n in leaves], dtype=torch.float64)
    return float(((prog - ref).abs() / ref).median())
