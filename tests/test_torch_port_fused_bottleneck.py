"""The port's fused bottleneck (plain version, BN folding, wrapper checks,
the split of the work) against the JAX package's Pallas kernel (interpret
mode) and reference; and a model of the CUDA kernel's bfloat16 arithmetic
against the Pallas kernel on bf16 inputs and against the plain version,
which is the argument behind ``chip_smoke.BF16_TOL``.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against ``bottleneck_reference`` there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import BF16_TOL
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


# (N frames of 4 clips, H, Cin, Ci, Cout, kt, proj): the K1 shape table;
# the first five are the slow pathway's
SLICE_SHAPES = [(32, 64, 80, 64, 256, 1, True), (32, 64, 256, 64, 256, 1, False),
                (32, 32, 512, 128, 512, 1, False),
                (32, 16, 1024, 256, 1024, 3, False),
                (32, 8, 2048, 512, 2048, 3, False), (128, 64, 8, 8, 32, 3, True),
                (128, 64, 32, 8, 32, 3, False), (128, 32, 64, 16, 64, 3, False),
                (128, 16, 128, 32, 128, 3, False),
                (128, 8, 256, 64, 256, 3, False)]


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SLICE_SHAPES,
                         ids=[f"{s[2]}-{s[3]}-{s[4]}-h{s[1]}" for s in SLICE_SHAPES])
def test_plan_rows_fits_shared_memory_on_every_slice_shape(shape, elem):
    n, h, cin, ci, cout, kt, proj = shape
    split = tfb.plan(n, h, h, cin, ci, cout, kt, elem, proj)
    assert 1 <= split.rows <= h
    assert split.smem == tfb.smem_bytes(elem, h, h, ci, split.rows,
                                        split.ring) <= 232448
    assert split.ring >= (tfb.smem_bytes(2, h, h, ci, split.rows)
                          - tfb.smem_bytes(2, h, h, ci, split.rows, 0)
                          if elem == 2 else 0)
    assert split.cluster in (1, 2, 4, 8)
    assert split.ctas == split.cluster * n * -(-h // split.rows)
    assert split.ctas % split.cluster == 0
    assert split.pixels == split.rows * h
    if split.cluster > 1:  # each block of a cluster owns a slice of Ci, Cout
        assert elem == 2
        assert ci % (16 * split.cluster) == 0
        assert cout % (16 * split.cluster) == 0
    if elem == 2 and n == 32:  # the slow pathway: one weight byte, many
        # pixels (half of slow s5's 8 x 8 frame, so that it fills the card)
        assert split.pixels >= min(64, h * h // 2)


def test_plan_is_cached_per_shape():
    shape = (32, 16, 16, 1024, 256, 1024, 3, 2, False)
    tfb.plan(*shape)
    hits = tfb.plan.cache_info().hits
    assert tfb.plan(*shape) is tfb.plan(*shape)
    assert tfb.plan.cache_info().hits == hits + 2


def test_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):  # a one-row strip of W 4096, Ci 512
        tfb.plan(8, 8, 4096, 64, 512, 64, 1, 2, True)


def _round(t):
    return t.to(torch.bfloat16).float()


def _bf16_model(x, t_len, wa, ba, wb, bb, wc, bc, wp=None, bp=None):
    """The bfloat16 kernel's arithmetic: bf16 operands, f32 sums, and bf16
    rounding of a and b after bias and ReLU, of c + bc and the projected
    residual before the add, and of relu(c + res)."""
    n, h, w, cin = x.shape
    xf = x.float()
    if wa.shape[0] == 1:
        a = xf @ wa[0].float()
    else:
        xc = F.pad(xf.reshape(n // t_len, t_len, h, w, cin),
                   (0, 0, 0, 0, 0, 0, 1, 1))
        a = sum(xc[:, dt:dt + t_len] @ wa[dt].float()
                for dt in range(3)).reshape(n, h, w, -1)
    a = _round(torch.relu(a + ba))
    ap = F.pad(a, (0, 0, 1, 1, 1, 1))
    b = _round(torch.relu(sum(ap[:, dy:dy + h, dx:dx + w] @ wb[dy, dx].float()
                              for dy in range(3) for dx in range(3)) + bb))
    cv = _round(b @ wc.float() + bc)
    res = _round(xf @ wp.float() + bp) if wp is not None else xf
    return _round(torch.relu(cv + res))


# kt 1 and 3, identity and projection; the last the Pallas kernel runs in
# 8-row strips with halo rows
BF16_CASES = [CASES[0], CASES[1], CASES[2], CASES[3]]


def _mk_bf16(case):
    """Seeded bf16 inputs scaled as a trained block's are (outputs of order
    1-5), as torch tensors (weights bf16, biases f32) and JAX arrays."""
    B, T, H, Cin, Ci, Cout, kt, proj = case
    rs = np.random.RandomState(0)
    x = rs.randn(B * T, H, H, Cin).astype(np.float32)
    shapes = dict(wa=(kt, Cin, Ci), ba=(Ci,), wb=(3, 3, Ci, Ci), bb=(Ci,),
                  wc=(Ci, Cout), bc=(Cout,), wp=(Cin, Cout), bp=(Cout,))
    gain = dict(wa=(kt * Cin) ** -0.5, wb=(9 * Ci) ** -0.5, wc=Ci ** -0.5,
                wp=Cin ** -0.5)
    args = {k: (rs.randn(*shapes[k]) * gain.get(k, 0.1)).astype(np.float32)
            for k in NAMES if proj or k not in ("wp", "bp")}
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = {k: torch.from_numpy(v).to(torch.bfloat16 if k[0] == "w"
                                    else torch.float32)
          for k, v in args.items()}
    jx = jnp.asarray(tx.float().numpy(), jnp.bfloat16)
    jw = [None if k not in tw else
          jnp.asarray(tw[k].float().numpy(),
                      jnp.bfloat16 if k[0] == "w" else jnp.float32)
          for k in NAMES]
    return tx, [tw.get(k) for k in NAMES], jx, jw


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_model_matches_pallas_interpret(case):
    """Both round at the same points and differ only in f32 summation
    order, which can move a rounding (of a, b or the output) to the
    neighbouring bf16 value: each output within one bf16 ulp at the
    output's scale (8 bits of precision), and almost all equal."""
    tx, tw, jx, jw = _mk_bf16(case)
    T = case[1]
    got = _bf16_model(tx, T, *tw).numpy()
    ref = np.asarray(jfb.fused_bottleneck(jx, T, *jw, interpret=True)
                     .astype(jnp.float32))
    diff = np.abs(got - ref)
    ulp = 2.0 ** (np.floor(np.log2(max(1.0, np.abs(ref).max()))) - 7)
    assert diff.max() <= ulp
    assert (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_model_within_bf16_tol_of_plain_version(case):
    """The kernel's bf16 roundings against the plain version, which keeps
    float32 until the output, on the same bf16 inputs: within BF16_TOL of
    the output's scale."""
    tx, tw, _, _ = _mk_bf16(case)
    T = case[1]
    got = _bf16_model(tx, T, *tw)
    ref = tfb.bottleneck_reference(tx.float(), T, *[
        None if t is None else t.float() for t in tw])
    scale = max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= BF16_TOL * scale
