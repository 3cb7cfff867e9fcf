"""The port's fused bottleneck (plain version, BN folding, wrapper checks)
against the JAX package's Pallas kernel (interpret mode) and reference.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against ``bottleneck_reference`` there."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from efficient_slowfast_tpu.ops.pallas import fused_bottleneck as jfb
from efficient_slowfast_tpu_torch.ops.kernels import fused_bottleneck as tfb

CASES = [
    # (B, T, H, Cin, Ci, Cout, kt, proj) — tests/test_fused_bottleneck.py:30-38
    (2, 4, 8, 16, 8, 16, 1, False),
    (2, 4, 8, 16, 8, 16, 3, False),
    (2, 4, 8, 16, 8, 16, 3, True),
    (1, 4, 64, 256, 64, 256, 1, False),
    (1, 8, 64, 32, 8, 32, 3, False),
    (2, 4, 64, 32, 8, 32, 3, True),
]
NAMES = ("wa", "ba", "wb", "bb", "wc", "bc", "wp", "bp")


def _mk(B, T, H, Cin, Ci, Cout, kt, proj, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B * T, H, H, Cin).astype(np.float32)
    shapes = dict(wa=(kt, Cin, Ci), ba=(Ci,), wb=(3, 3, Ci, Ci), bb=(Ci,),
                  wc=(Ci, Cout), bc=(Cout,), wp=(Cin, Cout), bp=(Cout,))
    args = {k: (rs.randn(*shapes[k]) * 0.1).astype(np.float32)
            for k in NAMES if proj or k not in ("wp", "bp")}
    return x, args


def _port(x, T, args):
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    return tfb.bottleneck_reference(
        torch.from_numpy(x), T, t["wa"], t["ba"], t["wb"], t["bb"], t["wc"],
        t["bc"], t.get("wp"), t.get("bp")).numpy()


def _jax_args(args):
    return [jnp.asarray(args[k]) if k in args else None for k in NAMES]


@pytest.mark.parametrize("case", CASES[:3])
def test_plain_matches_pallas_interpret(case):
    x, args = _mk(*case)
    T = case[1]
    ref = jfb.fused_bottleneck(jnp.asarray(x), T, *_jax_args(args),
                               interpret=True)
    np.testing.assert_allclose(_port(x, T, args), np.asarray(ref),
                               rtol=1e-5, atol=2e-4)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_reference(case):
    x, args = _mk(*case)
    T = case[1]
    ref = jfb.bottleneck_reference(jnp.asarray(x), T, *_jax_args(args))
    np.testing.assert_allclose(_port(x, T, args), np.asarray(ref),
                               rtol=1e-5, atol=2e-4)


def test_wrapper_on_cpu_is_the_plain_version():
    x, args = _mk(*CASES[2])
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    before = tfb.fused_bottleneck.launches
    out = tfb.fused_bottleneck(torch.from_numpy(x), 4, *[t[k] for k in NAMES])
    np.testing.assert_array_equal(out.numpy(), _port(x, 4, args))
    assert tfb.fused_bottleneck.launches == before  # no kernel on the CPU


def test_fold_bn_matches_jax():
    rs = np.random.RandomState(1)
    k = (rs.randn(3, 1, 1, 8, 16) * 0.2).astype(np.float32)
    scale = (rs.rand(16) + 0.5).astype(np.float32)
    bias = rs.randn(16).astype(np.float32)
    mean = (rs.randn(16) * 0.2).astype(np.float32)
    var = (rs.rand(16) + 0.3).astype(np.float32)
    jk, jb = jfb.fold_bn(*(jnp.asarray(a) for a in (k, scale, bias, mean, var)),
                         1e-5)
    tk, tb = tfb.fold_bn(*(torch.from_numpy(a)
                           for a in (k, scale, bias, mean, var)), 1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bad", [dict(stride=2), dict(groups=2),
                                 dict(dilation=2), dict(dtype=torch.float16)])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x, args = _mk(*CASES[0])
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    xt = torch.from_numpy(x).to(bad.pop("dtype", torch.float32))
    with pytest.raises((ValueError, TypeError)):
        tfb.fused_bottleneck(xt, 4, *[t.get(k) for k in NAMES], **bad)


def test_plan_rows_fits_shared_memory_on_every_slice_shape():
    # (N frames of 4 clips, H, Cin, Ci, Cout, kt, proj): the K1 shape table
    rows = [(32, 64, 80, 64, 256, 1, True), (32, 64, 256, 64, 256, 1, False),
            (32, 32, 512, 128, 512, 1, False),
            (32, 16, 1024, 256, 1024, 3, False),
            (32, 8, 2048, 512, 2048, 3, False), (128, 64, 8, 8, 32, 3, True),
            (128, 64, 32, 8, 32, 3, False), (128, 32, 64, 16, 64, 3, False),
            (128, 16, 128, 32, 128, 3, False), (128, 8, 256, 64, 256, 3, False)]
    for n, h, cin, ci, cout, kt, proj in rows:
        for elem in (2, 4):
            r = tfb.plan_rows(n, h, h, cin, ci, cout, kt, elem, proj)
            assert 1 <= r <= h
            assert tfb.smem_bytes(elem, h, ci, r) <= 232448
