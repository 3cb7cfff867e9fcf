"""Seeded weights, inputs and the attention calibration, made on the device.

The recipe is the one the repository's chip smoke test uses
(``chip_smoke.py``: ``jax_layout_weights``, ``calibrate_attention`` and
``ATTN_LOGIT_STD``), copied here and drawn on the device in a few large
calls instead of leaf by leaf on the host:

- convolutions MSRA fan-out normal, N(0, 2 / (Cout·kT·kH·kW)); the
  classifier N(0, 0.01²); ECA's 3-tap Conv1d N(0, 1/3); every bias 0;
- BN scale 1 and bias 0, the running statistics jittered (mean 0.05 (k mod
  7 − 3), variance 1 + 0.1 (k mod 5), k counting the statistics in order);
- every attention γ 0.5, since at its zero init the attention would never
  reach the output;
- CMDA's attention is unscaled, and on such weights its logits reach a
  standard deviation of thousands at s4_fuse, where the softmax is an argmax
  that one rounding flips. Each fusion's query and key convs (weight and
  bias) are scaled by one factor so that its logits have a standard
  deviation of ``LOGIT_STD`` on one seeded clip, fusion by fusion, in the
  plain reference's eval forward.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from .reference.model import Arch, Net, float32_products

LOGIT_STD = 3.0


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of draws of the run ``seed``."""
    state = np.random.SeedSequence([int(seed), *stream]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device, seed: int, *stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *stream))


def _std(kind: str, shape) -> float:
    if kind == "conv":
        return math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
    if kind == "fc":
        return 0.01
    return 1.0 / math.sqrt(shape[-1])  # eca: fan-in 3


def make_weights(spec, seed: int, device) -> dict:
    """The float32 weights of ``spec`` (``reference.model.param_spec``)."""
    drawn = [n for n, (_, kind) in spec.items() if kind in ("conv", "fc", "eca")]
    sizes = [math.prod(spec[n][0]) for n in drawn]
    flat = torch.randn(sum(sizes), generator=generator(device, seed, 1),
                       device=device)
    w = {}
    for name, part in zip(drawn, flat.split(sizes)):
        shape, kind = spec[name]
        w[name] = part.view(shape).mul_(_std(kind, shape))
    k = 0
    for name, (shape, kind) in spec.items():
        if name in w:
            continue
        if kind in ("bn_mean", "bn_var"):
            k += 1
        value = {"bn_weight": 1.0, "bn_bias": 0.0, "bias": 0.0, "gamma": 0.5,
                 "bn_mean": 0.05 * (k % 7 - 3),
                 "bn_var": 1.0 + 0.1 * (k % 5)}[kind]
        w[name] = torch.full(shape, value, device=device)
    return w


def state_dict(spec, w: dict) -> dict:
    """``w`` as the program's state_dict: the BN counters added."""
    out = {}
    for name in spec:
        out[name] = w[name]
        if name.endswith(".running_var"):
            out[name[:-len("running_var")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.long, device=w[name].device)
    return out


def clips(arch: Arch, batch: int, crop: int, gen: torch.Generator, device,
          dtype=torch.bfloat16) -> list:
    """[slow (B, T/α, S, S, 3), fast (B, T, S, S, 3)]: standard normal
    pixels under each clip's own colour statistics (a mean N(0, 0.5²) and a
    scale exp N(0, 0.3²) for each of its channels), so that clips differ
    after the head's pooling as videos do, and do not all score alike."""
    t = arch.num_frames
    mean = torch.randn((batch, 1, 1, 1, 3), generator=gen, device=device)
    scale = torch.randn((batch, 1, 1, 1, 3), generator=gen,
                        device=device).mul_(0.3).exp_()
    out = []
    for frames in (t // arch.alpha, t):
        x = torch.randn((batch, frames, crop, crop, 3), generator=gen,
                        device=device, dtype=dtype)
        out.append(x.mul_(scale.to(dtype)).add_(mean.mul(0.5).to(dtype)))
    return out


def calibrate(arch: Arch, w: dict, clip: list) -> List[float]:
    """Scale each fusion's query and key convs in ``w`` (in place) so that
    its logits have ``LOGIT_STD`` on ``clip``; returns the standard
    deviations found before."""
    found = []

    def scale(name, q, k):
        std = torch.bmm(q[:, ::64], k.transpose(1, 2)).std().item()
        f = math.sqrt(LOGIT_STD / std)
        for conv in ("query_conv", "key_conv"):
            w[f"{name}.{conv}.weight"].mul_(f)
            w[f"{name}.{conv}.bias"].mul_(f)
        found.append(std)
        return f

    if arch.cmda:
        with torch.no_grad(), float32_products():
            Net(arch, w, on_attention=scale)(clip)
    return found
