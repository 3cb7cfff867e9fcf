"""The frozen formulas against hand counts and torch's own count of the
plain computations at tiny shapes."""

import os

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from port_bench import formulas, manifest
from port_bench.reference.attention import dense
from port_bench.reference.model import arch_from
from port_bench.tests import tiny


def _count(fn):
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def test_k1_hand_count():
    flops, nbytes = formulas.k1((2, 4, 4, 8), (3, 8, 4), (3, 3, 4, 4),
                                (4, 16), (8, 16))
    assert flops == 2 * 32 * (3 * 8 * 4 + 9 * 16 + 4 * 16 + 8 * 16)
    assert nbytes == 2 * (32 * (8 + 16) + 96 + 144 + 64 + 128) + 4 * 40
    flops, _ = formulas.k1((2, 4, 4, 16), (1, 16, 4), (3, 3, 4, 4),
                           (4, 16), [])
    assert flops == 2 * 32 * (16 * 4 + 9 * 16 + 4 * 16)


def test_k1_matches_the_convolutions_it_fuses():
    x = torch.randn(2, 8, 4, 4, 4)  # (B, C, T, H, W), t_len 4
    wa, wb = torch.randn(4, 8, 3, 1, 1), torch.randn(4, 4, 1, 3, 3)
    wc, wp = torch.randn(16, 4, 1, 1, 1), torch.randn(16, 8, 1, 1, 1)

    def block():
        a = F.conv3d(x, wa, padding=(1, 0, 0))
        c = F.conv3d(F.conv3d(a, wb, padding=(0, 1, 1)), wc)
        return c + F.conv3d(x, wp)

    flops, _ = formulas.k1((8, 4, 4, 8), (3, 8, 4), (3, 3, 4, 4), (4, 16),
                           (8, 16))
    assert flops == _count(block)


def test_k2_and_backward_hand_counts():
    assert formulas.k2((2, 10, 4), (2, 6, 4), (2, 6, 3), False) == (
        2 * 2 * 10 * 6 * 7, 2 * 2 * (40 + 24 + 18 + 30))
    assert formulas.k2((2, 10, 4), (2, 6, 4), (2, 6, 3), True)[1] == \
        448 + 4 * 2 * 10
    assert formulas.k2_backward((2, 10, 4), (2, 6, 4), (2, 6, 3)) == (
        4 * 2 * 10 * 6 * 7, 2 * 2 * (2 * 82 + 2 * 30) + 80)


def test_k2_counts_match_torch_on_the_plain_attention():
    q, k = torch.randn(2, 10, 4, requires_grad=True), torch.randn(2, 6, 4)
    v = torch.randn(2, 6, 3, requires_grad=True)
    k.requires_grad_()
    fwd = formulas.k2(q.shape, k.shape, v.shape, False)[0]
    assert _count(lambda: dense(q, k, v)) == fwd
    out = dense(q, k, v)
    assert _count(lambda: out.sum().backward()) == \
        formulas.k2_backward(q.shape, k.shape, v.shape)[0]


def test_model_flops_train_is_about_three_forwards():
    for name in ("slowfast_r50_8x8", "cmda_r50_8x8"):
        arch = arch_from(tiny.config(name)["cfg"])
        fwd = formulas.model_flops_per_clip(arch, 64, False)
        train = formulas.model_flops_per_clip(arch, 64, True)
        assert fwd > 0 and 2.5 * fwd < train <= 3.0 * fwd


def test_full_size_forward_flops():
    """SlowFast-R50 8x8: PySlowFast's model zoo lists 65.7 GFLOPs
    (multiply-adds) a view."""
    arch = arch_from(manifest.read_json(os.path.join(
        manifest.HERE, "configs", "slowfast_r50_8x8.json"))["cfg"])
    macs = formulas.model_flops_per_clip(arch, 256, False) / 2
    assert abs(macs / 65.7e9 - 1) < 0.03
