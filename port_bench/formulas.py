"""The yardstick: the card's published peaks, the operations and bytes of
each kernel's op from its shapes, and the model's operations a clip.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM. Exponentials
get no roof: a kernel may compute some of them on the FMA pipes, so a roof
derived from the special-function units' rate would be no bound.

A kernel's least time is the larger of its operations over the peak and
its bytes over the bandwidth, each input read once and each output written
once. The model's operations a clip are those of the plain reference,
counted by ``torch.utils.flop_counter`` on the meta device with the dense
attention (so nothing recomputed is counted, and no port op is involved).
"""

from __future__ import annotations

import functools
import math

import torch

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def k1(x, wa, wb, wc, wp, elem: int = 2):
    """(FLOPs, bytes) of one fused bottleneck (``esf_torch::
    fused_bottleneck``): x (N, H, W, Cin), wa (kT, Cin, Ci), wb (3, 3, Ci,
    Ci), wc (Ci, Cout), wp (Cin, Cout) or empty; float32 biases."""
    n, h, w, cin = x
    kt, _, ci = wa
    cout = wc[1]
    proj = bool(wp)
    flops = 2 * n * h * w * (kt * cin * ci + 9 * ci * ci + ci * cout
                             + (cin * cout if proj else 0))
    weights = math.prod(wa) + math.prod(wb) + math.prod(wc) + (
        math.prod(wp) if proj else 0)
    biases = 2 * ci + cout + (cout if proj else 0)
    nbytes = elem * (n * h * w * (cin + cout) + weights) + 4 * biases
    return flops, nbytes


def k2(q, k, v, with_lse: bool, elem: int = 2):
    """(FLOPs, bytes) of one attention forward (``esf_torch::
    flash_attention``): q (B, N, D), k (B, M, D), v (B, M, C); out (B, N,
    C), and the float32 log-sum-exp where it is kept."""
    b, n, d = q
    m, c = k[1], v[2]
    flops = 2 * b * n * m * (d + c)
    nbytes = elem * b * (n * d + m * d + m * c + n * c) + (
        4 * b * n if with_lse else 0)
    return flops, nbytes


def k2_backward(q, k, v, elem: int = 2):
    """(FLOPs, bytes) of one attention backward: dV = Pᵀ dO, dP = dO vᵀ,
    dQ = dS k, dK = dSᵀ q (the logits' recompute not counted); q, k, v,
    out, dout and the log-sum-exp read, dq, dk, dv written."""
    b, n, d = q
    m, c = k[1], v[2]
    flops = 4 * b * n * m * (d + c)
    nbytes = elem * b * (2 * (n * d + m * d + m * c) + 2 * n * c) + 4 * b * n
    return flops, nbytes


@functools.lru_cache(maxsize=None)
def model_flops_per_clip(arch, crop: int, train: bool) -> float:
    """The reference's operations for one clip at ``crop``: the forward,
    or the forward and backward of the loss."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.attention import dense
    from .reference.model import Net, cross_entropy, param_spec

    dev = torch.device("meta")
    spec = param_spec(arch)
    w = {n: torch.empty(s, device=dev, requires_grad=train
                        and k not in ("bn_mean", "bn_var"))
         for n, (s, k) in spec.items()}
    t = arch.num_frames
    inputs = [torch.empty((1, t // arch.alpha, crop, crop, 3), device=dev),
              torch.empty((1, t, crop, crop, 3), device=dev)]
    counter = FlopCounterMode(display=False)
    with counter, torch.set_grad_enabled(train):
        out = Net(arch, w, train=train, attend=dense)(inputs)
        if train:
            cross_entropy(out, torch.zeros(1, dtype=torch.long,
                                           device=dev)).backward()
    return float(counter.get_total_flops())
