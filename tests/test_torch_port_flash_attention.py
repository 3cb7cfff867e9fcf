"""The port's flash attention (plain version, wrapper checks) against the JAX
package's chunked attention, a dense softmax, and the Pallas kernel body
itself run in interpret mode, f32 on the CPU; and a model of the CUDA
kernel's bfloat16 arithmetic against the JAX package's chunked attention,
which is the argument behind ``chip_smoke.ATTN_BF16_TOL``.

The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it against
``chunked_attention`` there."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from chip_smoke import ATTN_BF16_TOL
from efficient_slowfast_tpu.ops.pallas import flash_attention as jfa
from efficient_slowfast_tpu_torch.ops.kernels import flash_attention as tfa

TOL = dict(rtol=1e-4, atol=1e-5)
CASES = {
    # (B, N, M, D, C, chunk): tests/test_flash_attention.py:24-37, then a
    # ragged M != N and a D != C case
    "n700_chunk256": (2, 700, 700, 8, 16, 256),
    "n130_chunk64_padded": (2, 130, 130, 8, 16, 64),
    "ragged_m": (2, 300, 130, 8, 16, 64),
    "d_ne_c": (1, 200, 333, 4, 24, 128),
    # the non-local blocks' widths: s3's 256, s4's 512
    "d_c_256": (2, 200, 90, 256, 256, 64),
    "d_c_512": (1, 130, 70, 512, 512, 64),
}


def _qkv(b, n, m, d, c, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, n, d).astype(np.float32),
            rs.randn(b, m, d).astype(np.float32),
            rs.randn(b, m, c).astype(np.float32))


def _dense(q, k, v):
    logits = np.einsum("bnd,bmd->bnm", q.astype(np.float64),
                       k.astype(np.float64))
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return np.einsum("bnm,bmc->bnc", p / p.sum(-1, keepdims=True), v)


def _port(q, k, v, **kw):
    return tfa.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 **kw).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_matches_jax_chunked_and_dense(case):
    b, n, m, d, c, chunk = CASES[case]
    q, k, v = _qkv(b, n, m, d, c)
    ref = np.asarray(jfa.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), chunk=chunk))
    out = _port(q, k, v, chunk=chunk)
    assert out.shape == (b, n, c) and out.dtype == np.float32
    # the wide cases at the tests' default 1e-4: f32 sums of 256-512 terms
    # into logits of std 16-23 (randn q and k)
    tol = TOL if d <= 128 else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, ref, **tol)
    np.testing.assert_allclose(out, _dense(q, k, v), **tol)


@pytest.mark.parametrize("b,n,d,c,block_q,block_k", [
    (1, 512, 8, 8, 256, 256),
    (2, 512, 4, 12, 128, 256),
])
def test_chunked_matches_pallas_kernel_interpret(monkeypatch, b, n, d, c,
                                                 block_q, block_k):
    # the Pallas body binds ``pl`` when _flash_forward first runs
    monkeypatch.setattr(jfa, "pl", pl, raising=False)
    q, k, v = _qkv(b, n, n, d, c, seed=1)
    call = pl.pallas_call(
        functools.partial(jfa._flash_kernel, block_k=block_k),
        out_shape=jax.ShapeDtypeStruct((b, n, c), jnp.float32),
        grid=(b, n // block_q),
        in_specs=[pl.BlockSpec((1, block_q, d), lambda bi, qi: (bi, qi, 0)),
                  pl.BlockSpec((1, n, d), lambda bi, qi: (bi, 0, 0)),
                  pl.BlockSpec((1, n, c), lambda bi, qi: (bi, 0, 0))],
        out_specs=pl.BlockSpec((1, block_q, c), lambda bi, qi: (bi, qi, 0)),
        interpret=True)
    ref = np.asarray(call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(_port(q, k, v), ref, **TOL)


def test_bf16_inputs_are_upcast_and_the_output_is_bf16():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(1, 96, 80, 8, 8))
    out = tfa.chunked_attention(q, k, v, chunk=32)
    assert out.dtype == torch.bfloat16
    ref = tfa.chunked_attention(q.float(), k.float(), v.float(), chunk=32)
    torch.testing.assert_close(out, ref.bfloat16(), rtol=0, atol=0)


def test_wrapper_on_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 130, 70, 8, 16))
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v)
    torch.testing.assert_close(out, tfa.chunked_attention(q, k, v),
                               rtol=0, atol=0)
    assert tfa.flash_attention.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("bad", ["int_dtype", "mixed_dtype",
                                 "batch_mismatch", "keys_mismatch",
                                 "d_mismatch", "rank"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    b, n, m, d, c = 2, 16, 24, 8, 8
    shapes = {"q": (b, n, d), "k": (b, m, d), "v": (b, m, c)}
    dtypes = dict.fromkeys(shapes, torch.float32)
    if bad == "int_dtype":
        dtypes = dict.fromkeys(shapes, torch.int32)
    elif bad == "mixed_dtype":
        dtypes["v"] = torch.bfloat16
    elif bad == "batch_mismatch":
        shapes["k"] = (b + 1, m, d)
    elif bad == "keys_mismatch":
        shapes["v"] = (b, m + 1, c)
    elif bad == "d_mismatch":
        shapes["k"] = (b, m, d + 1)
    elif bad == "rank":
        shapes["q"] = (b * n, d)
    args = [torch.zeros(shapes[x], dtype=dtypes[x]) for x in "qkv"]
    with pytest.raises((ValueError, TypeError)):
        tfa.flash_attention(*args)


def _kernel_bf16_model(q, k, v, tile=64, parts=None):
    """The arithmetic of ``csrc/flash_attention.cu``'s bfloat16 kernels: f32
    logits of the bf16 q and k, the softmax online over key tiles in f32,
    each probability rounded once to bf16 before the f32-accumulated
    product with the bf16 v, the row sum taken from the unrounded
    probabilities. The cluster kernel (D or C above 128) takes ``tile`` =
    32 or 64 keys and, where its blocks exchange, adds the pushers' partial
    logits (``parts``: each pusher's columns of D) in rank order in
    float32. Returns the f32 output before its rounding to bf16."""
    b, n, d = q.shape
    m, c = v.shape[1], v.shape[2]
    acc = torch.zeros(b, n, c)
    row_max = torch.full((b, n), -float("inf"))
    row_sum = torch.zeros(b, n)
    for s in range(0, m, tile):
        kt = k[:, s:s + tile].float()
        logits = 0
        for cols in parts or [slice(0, d)]:  # rank order, 0 first
            logits = logits + (q[..., cols].float()
                               @ kt[..., cols].transpose(1, 2))
        new_max = torch.maximum(row_max, logits.amax(-1))
        corr = torch.exp(row_max - new_max)
        p = torch.exp(logits - new_max[..., None])
        row_sum = row_sum * corr + p.sum(-1)
        acc = (acc * corr[..., None]
               + p.bfloat16().float() @ v[:, s:s + tile].float())
        row_max = new_max
    return acc / row_sum.clamp(min=1e-30)[..., None]


def _kernel_split(b, n, m, d, c):
    """(tile, parts) of the kernel that takes D, C: the narrow one up to
    128, else the cluster kernel's forward_split, whose pushers own
    ``slices`` 256-column slices of D each (q resident up to D = 2048,
    streamed beyond)."""
    if d <= 128 and c <= 128:
        return 64, None
    plan = tfa.forward_split(b, n, m, d, c)
    if not plan["exchange"]:
        return plan["keys"], None
    width = plan["slices"] * plan["d_slice"]
    return plan["keys"], [slice(p * width, (p + 1) * width)
                          for p in range(plan["pushers"])]


@pytest.mark.parametrize("logit_std", [3.0, 11.0])
@pytest.mark.parametrize("dim", [8, 32, 64, 128, 256, 512] + [
    pytest.param(dc, id=f"{dc[0]}x{dc[1]}")
    for dc in ((1024, 1024), (64, 1100), (1100, 64), (600, 700),
               (3072, 3072), (300, 2100))])
def test_bf16_kernel_arithmetic_within_attn_bf16_tol(dim, logit_std):
    # D = C as at the four CMDA-R50 fusions and the non-local blocks (256,
    # 512, the res5's 1024), and D and C apart where the cluster kernel
    # splits C over 8 blocks that one pusher's logits reach (64, 1100),
    # splits D over a cluster of 4 (1100, 64) or both (600, 700); beyond
    # 2048, two column groups whose 4 pushers stream q over 3 slices each
    # (3072, 3072) or own one slice each (300, 2100); N small, M ragged
    # against the kernel's key tile; q and k scaled so that the logits have
    # the given standard deviation (3 as chip_smoke calibrates the model,
    # 11 a peakier softmax)
    d, c = dim if isinstance(dim, tuple) else (dim, dim)
    b, n, m = 2, 70, 200
    q, k, v = _qkv(b, n, m, d, c, seed=d if d == c else d + 7 * c)
    scale = (logit_std / np.sqrt(d)) ** 0.5
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (q * scale, k * scale, v))
    tile, parts = _kernel_split(b, n, m, d, c)
    model = _kernel_bf16_model(q, k, v, tile, parts)
    exact = tfa.chunked_attention(q.float(), k.float(), v.float())
    # the rounding of P alone moves the output by at most 2^-9 max|v| (the
    # weights are off by at most 2^-9 relative); f32 sums add ~1e-6
    assert (model - exact).abs().max() <= 2.0 ** -9 * v.float().abs().max() + 1e-5
    # what chip_smoke holds the kernel to: the bf16 output against the plain
    # version, the JAX package's and the port's, within ATTN_BF16_TOL of
    # the output's scale (the argument is beside the constant)
    out = model.bfloat16().float()
    jax_ref = np.array(jfa.chunked_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        chunk=64).astype(jnp.float32))
    port_ref = tfa.chunked_attention(q, k, v).float()
    for ref in (torch.from_numpy(jax_ref), port_ref):
        tol = ATTN_BF16_TOL * max(1.0, ref.abs().max().item())
        assert (out - ref).abs().max().item() <= tol


def test_plain_version_at_the_widest_c_matches_jax():
    # a width a planner of at most 64 blocks a tile cannot split: D 256, C
    # 16448 (nine column groups), tiny N and M
    q, k, v = _qkv(1, 9, 13, 256, 16448, seed=5)
    q, k = q * 0.25, k * 0.25  # logits of std 1
    want = np.asarray(jfa.chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v)), chunk=8))
    got = tfa.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert tfa.forward_split(1, 9, 13, 256, 16448)["groups"] == 9
