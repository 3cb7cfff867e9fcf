"""flash_attention's gradient on the CPU: the port's autograd Function (its
forward ``chunked_attention_lse``, its backward ``attention_backward``)
against ``jax.vjp`` of the JAX package's ``flash_attention``, whose
custom_vjp runs ``chunked_attention`` and its vjp on the CPU; f32 at 1e-5,
bf16 inputs within ``chip_smoke.ATTN_BWD_BF16_TOL``. Also a model of the
CUDA backward kernel's bf16 arithmetic against the plain version, which is
the argument behind that tolerance (with its dQ summed over key blocks in a
shuffled order, as the kernel's atomic adds arrive), the wrapper's
zero-padding of widths that TMA cannot take, and the wrapper's checks.

The CUDA kernels run only on the card; ``chip_smoke.py`` holds them
against the plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_BWD_BF16_TOL
from efficient_slowfast_tpu.ops.pallas import flash_attention as jfa
from efficient_slowfast_tpu_torch.ops.kernels import flash_attention as tfa
from torch_port_helpers import compiled

CASES = {
    # (B, N, M, D, C)
    "square": (2, 300, 300, 8, 8),
    "ragged_m": (2, 300, 130, 8, 16),
    "n_ne_m": (1, 200, 777, 32, 32),
    "d_ne_c": (1, 200, 333, 4, 24),
    # the non-local blocks' widths: s3's 256, s4's 512
    "d_c_256": (1, 200, 90, 256, 256),
    "d_c_512": (1, 130, 70, 512, 512),
}


def _arrays(b, n, m, d, c, seed=0, logit_std=3.0):
    rs = np.random.RandomState(seed)
    s = (logit_std / np.sqrt(d)) ** 0.5  # q and k scaled to that logit std
    return ((rs.randn(b, n, d) * s).astype(np.float32),
            (rs.randn(b, m, d) * s).astype(np.float32),
            rs.randn(b, m, c).astype(np.float32),
            rs.randn(b, n, c).astype(np.float32))


def _forward_and_vjp(q, k, v, g):
    out, vjp = jax.vjp(jfa.flash_attention, q, k, v)
    return (out, *vjp(g))


def _jax_vjp(q, k, v, g, dtype=jnp.float32):
    # one compiled program a shape: the forward and its vjp together
    return [np.asarray(t.astype(jnp.float32)) for t in compiled(
        _forward_and_vjp, *(jnp.asarray(a, dtype) for a in (q, k, v, g)))]


def _port_grads(q, k, v, g, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (q, k, v)]
    out = tfa.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves,
                                torch.from_numpy(g).to(dtype))
    return out, grads


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax_vjp_f32(case):
    q, k, v, g = _arrays(*CASES[case])
    ref = _jax_vjp(q, k, v, g)
    out, grads = _port_grads(q, k, v, g)
    assert isinstance(out.grad_fn,
                      tfa.AttentionFunction._backward_cls)
    # the wide cases at the tests' default 1e-4: f32 sums of 256-512 terms
    tol = 1e-5 if CASES[case][3] <= 128 else 1e-4
    for got, want in zip((out, *grads), ref):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("case", ["ragged_m", "d_ne_c"])
def test_gradients_match_jax_vjp_bf16_inputs(case):
    # both run f32 inside from the same bf16 inputs and round each gradient
    # to bf16, but the port takes D = rowsum(dO ∘ O) from the bf16 output
    # it kept, JAX's vjp from the unrounded one: ATTN_BWD_BF16_TOL argues
    # both effects
    q, k, v, g = _arrays(*CASES[case], seed=1)
    ref = _jax_vjp(q, k, v, g, jnp.bfloat16)
    out, grads = _port_grads(q, k, v, g, torch.bfloat16)
    for got, want in zip((out, *grads), ref):
        assert got.dtype == torch.bfloat16
        err = np.abs(got.detach().float().numpy() - want).max()
        assert err <= ATTN_BWD_BF16_TOL * max(1.0, np.abs(want).max()), err


def test_the_repaired_fault_output_carries_the_function_grad_fn():
    # ROADMAP §3: the CUDA forward wrote into an empty buffer and returned
    # no grad_fn, so the query, key and value convs of a CMDA train step got
    # no gradient through the attention. Every device now goes through
    # AttentionFunction, and its backward reaches all three inputs.
    q, k, v, g = _arrays(1, 70, 90, 8, 8)
    out, grads = _port_grads(q, k, v, g)
    assert type(out.grad_fn).__name__ == "AttentionFunctionBackward"
    assert all(float(t.abs().max()) > 0 for t in grads)


def test_plain_attention_is_the_function_over_the_plain_versions():
    arrays = _arrays(2, 90, 70, 8, 16)
    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    with torch.no_grad():
        torch.testing.assert_close(tfa.plain_attention(q, k, v),
                                   tfa.chunked_attention(q, k, v),
                                   rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tfa.plain_attention(*leaves)
    assert type(out.grad_fn).__name__ == "AttentionFunctionBackward"
    got = torch.autograd.grad(out, leaves, g)
    lse = tfa.chunked_attention_lse(q, k, v)[1]
    for a, b in zip(got, tfa.attention_backward(q, k, v, out.detach(), lse,
                                                g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_serving_keeps_no_log_sum_exp(monkeypatch):
    asked = []
    forward = tfa._forward
    monkeypatch.setattr(tfa, "_forward", lambda q, k, v, with_lse: (
        asked.append(with_lse) or forward(q, k, v, with_lse)))
    q, k, v = (torch.from_numpy(a) for a in _arrays(1, 70, 90, 8, 8)[:3])
    with torch.inference_mode():
        out = tfa.flash_attention(q, k, v)
    assert out.grad_fn is None and asked == [False]
    with torch.no_grad():
        tfa.flash_attention(q.requires_grad_(), k, v)
    assert asked == [False, False]
    assert tfa.flash_attention(q, k, v).grad_fn is not None
    assert asked == [False, False, True]


def test_chunked_attention_lse_is_the_log_sum_exp():
    q, k, v, _ = _arrays(2, 130, 333, 8, 16, logit_std=11.0)
    out, lse = tfa.chunked_attention_lse(*(torch.from_numpy(a)
                                           for a in (q, k, v)), chunk=64)
    logits = np.einsum("bnd,bmd->bnm", q.astype(np.float64),
                       k.astype(np.float64))
    mx = logits.max(-1)
    want = mx + np.log(np.exp(logits - mx[..., None]).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(out, tfa.chunked_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), chunk=64), rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [64, 512])
def test_attention_backward_matches_autograd_of_chunked_attention(chunk):
    # JAX's _bwd written out: autograd through chunked_attention
    q, k, v, g = _arrays(2, 150, 301, 16, 12)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, lse = tfa.chunked_attention_lse(*leaves)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    got = tfa.attention_backward(*(t.detach() for t in leaves), out.detach(),
                                 lse.detach(), torch.from_numpy(g),
                                 chunk=chunk)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _kernel_bwd_bf16_model(q, k, v, out, lse, dout, seed=0):
    """The arithmetic of ``csrc/flash_attention_bwd.cu``'s bf16 kernels:
    f32 products of the bf16 operands (its wgmma accumulates in f32), D
    from the bf16 out and dout in f32, P = exp(q kᵀ − lse) and dS = P∘(dO vᵀ
    − D) in f32, each rounded once to bf16 (P and dS as the register A
    operands of Pᵀ dO and dSᵀ q, dS also as the shared-memory operand of
    dS k), the sums in f32. With D or C above 128 (the cluster kernel) q kᵀ
    and dO vᵀ are sums of partials over 128-column slices: each
    warpgroup's over its half of block r's 256-column slices r + R j (the
    own slice of the first column group first), a block's two warpgroups'
    added first, then the cluster's R blocks' in rank order; dQ is the sum
    of the 64-key blocks' parts dS k, added into a float32 accumulator in
    an order (``seed``) as its bulk reduce-adds arrive. Returns the f32
    gradients before their rounding to bf16."""
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, dout))
    delta = (gf * of).sum(-1)
    d, c = q.shape[-1], v.shape[-1]
    if max(d, c) <= 128:
        s, dp = qf @ kf.transpose(1, 2), gf @ vf.transpose(1, 2)
    else:
        plan = tfa.backward_cluster_split(1, q.shape[1], k.shape[1], d, c)
        r, groups = plan["cluster"], plan["groups"]
        part = lambda x, y, j: (x[..., 128 * j:128 * j + 128]
                                @ y[..., 128 * j:128 * j + 128]
                                .transpose(1, 2))

        def block(x, y, rank):  # its warpgroups' partials, added
            wg = [0, 0]
            for j in range(groups):
                for w in range(2):
                    wg[w] = wg[w] + part(x, y, 2 * (rank + r * j) + w)
            return wg[1] + wg[0]

        s = dp = 0
        for rank in range(r):  # rank order
            s = s + block(qf, kf, rank)
            dp = dp + block(gf, vf, rank)
    p = torch.exp(s - lse[..., None])
    ds = p * (dp - delta[..., None])
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.zeros_like(qf)
    starts = list(range(0, k.shape[1], 64))
    np.random.RandomState(seed).shuffle(starts)
    for j in starts:
        dq += dsb[..., j:j + 64] @ kf[:, j:j + 64]
    return dq, dsb.transpose(1, 2) @ qf, pb.transpose(1, 2) @ gf


@pytest.mark.parametrize("logit_std", [3.0, 11.0])
@pytest.mark.parametrize("dim", [8, 32, 64, 128, 256, 512] + [
    pytest.param(w, id=f"{w[0]}x{w[1]}")
    for w in ((1024, 1024), (600, 700), (64, 2048), (2048, 64), (3072, 3072),
              (300, 2100))])
def test_bf16_kernel_arithmetic_within_attn_bwd_bf16_tol(dim, logit_std):
    # D = C as at the four CMDA-R50 fusions and the non-local blocks (the
    # cluster kernel above 128 rounds P and dS to bf16 as the one-pass
    # kernel does), the wide widths D, C of one column group and, beyond
    # 2048, of two (3072, 3072) and (300, 2100);
    # logits of std 3 (the smoke's calibration) and 11 (randn q and k at
    # D = 128, as phase 3c feeds them)
    d, c = dim if isinstance(dim, tuple) else (dim, dim)
    q, k, v, g = _arrays(1, 400, 333, d, c, seed=d, logit_std=logit_std)
    q, k, v, g = (torch.from_numpy(a).bfloat16() for a in (q, k, v, g))
    out, lse = tfa.chunked_attention_lse(q, k, v)
    model = _kernel_bwd_bf16_model(q, k, v, out, lse, g)
    plain = tfa.attention_backward(q, k, v, out, lse, g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(tfa.chunked_attention(*leaves), leaves, g)
    # what chip_smoke holds the kernel to: its bf16 gradients against the
    # plain version (D from the same bf16 out) and against autograd through
    # chunked_attention (D from the unrounded out), within
    # ATTN_BWD_BF16_TOL of each gradient's scale; beyond 2048 also against
    # jax.vjp of the JAX package's flash_attention on the same inputs
    refs = [[p.float(), a.float()] for p, a in zip(plain, auto)]
    if max(d, c) > 2048:
        jax_grads = _jax_vjp(*(t.float().numpy() for t in (q, k, v, g)))[1:]
        for r, j in zip(refs, jax_grads):
            r.append(torch.from_numpy(np.array(j)))
    for got, rs in zip(model, refs):
        got = got.bfloat16().float()
        for ref in rs:
            tol = ATTN_BWD_BF16_TOL * max(1.0, ref.abs().max().item())
            assert (got - ref).abs().max().item() <= tol


def _one_pass_dq_model(q, k, v, out, lse, dout, block, seed):
    """dQ as the one-pass kernel forms it: each block of ``block`` keys
    adds its part dS k (dS rounded to bf16, products and sums in f32) into
    a float32 accumulator, the blocks in a shuffled order, as its atomic
    adds arrive; then one rounding to bf16."""
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, dout))
    delta = (gf * of).sum(-1)
    acc = torch.zeros_like(qf)
    starts = list(range(0, k.shape[1], block))
    np.random.RandomState(seed).shuffle(starts)
    for s in starts:
        kb, vb = kf[:, s:s + block], vf[:, s:s + block]
        p = torch.exp(qf @ kb.transpose(1, 2) - lse[..., None])
        ds = (p * (gf @ vb.transpose(1, 2) - delta[..., None])).bfloat16()
        acc += ds.float() @ kb
    return acc.bfloat16()


@pytest.mark.parametrize("dim", [8, 32, 64, 128])
def test_one_pass_dq_accumulation_within_attn_bwd_bf16_tol(dim):
    # D = C as at the four CMDA-R50 fusions; keys in blocks of 128 (the
    # kernel's Bc at s1-s3_fuse), N and M ragged against the blocks and the
    # 64-query tiles. Two block orders agree far inside the tolerance: the
    # nondeterminism of bf16 dQ is in its last bits.
    q, k, v, g = _arrays(1, 333, 300, dim, dim, seed=dim)
    q, k, v, g = (torch.from_numpy(a).bfloat16() for a in (q, k, v, g))
    out, lse = tfa.chunked_attention_lse(q, k, v)
    want = tfa.attention_backward(q, k, v, out, lse, g)[0].float()
    tol = ATTN_BWD_BF16_TOL * max(1.0, want.abs().max().item())
    orders = [_one_pass_dq_model(q, k, v, out, lse, g, 128, seed)
              for seed in (0, 1)]
    for got in orders:
        assert (got.float() - want).abs().max().item() <= tol
    assert (orders[0].float() - orders[1].float()).abs().max().item() <= \
        tol / 10


@pytest.mark.parametrize("d,c", [(4, 4), (24, 24), (100, 100), (4, 100),
                                 (250, 250)])
def test_padding_to_a_multiple_of_8_is_exact(d, c):
    # what the CUDA wrapper does for widths or pointers that TMA cannot
    # take, run here with the plain version: zero columns change no logit,
    # no D = rowsum(dO ∘ O) and no dO vᵀ; N and M ragged
    arrays = _arrays(2, 77, 45, d, c, seed=d + c)
    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    out, lse = tfa.chunked_attention_lse(q, k, v)
    shapes = []

    def backward(*args):
        shapes.append(tuple(t.shape[-1] for t in args if t.dim() == 3))
        return tfa.attention_backward(*args)

    got = tfa.padded_backward(backward, q, k, v, out, lse, g)
    want = tfa.attention_backward(q, k, v, out, lse, g)
    dp, cp = -(-d // 8) * 8, -(-c // 8) * 8
    assert shapes == [(dp, dp, cp, cp, cp)]
    # rtol = atol = 1e-6 of each gradient's scale: the f32 dot products
    # over D + pad and D columns are blocked differently, so they round
    # apart by an ulp or two of their largest terms
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.is_contiguous()
        scale = max(1.0, b.abs().max().item())
        torch.testing.assert_close(a / scale, b / scale, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("bad", ["out_shape", "lse_shape", "dout_dtype",
                                 "lse_dtype"])
def test_backward_wrapper_refuses_what_the_kernel_does_not_take(bad):
    b, n, m, d, c = 2, 16, 24, 8, 8
    q, k, v = torch.zeros(b, n, d), torch.zeros(b, m, d), torch.zeros(b, m, c)
    out, dout, lse = torch.zeros(b, n, c), torch.zeros(b, n, c), \
        torch.zeros(b, n)
    if bad == "out_shape":
        out = torch.zeros(b, n, c + 1)
    elif bad == "lse_shape":
        lse = torch.zeros(b, n + 1)
    elif bad == "dout_dtype":
        dout = dout.bfloat16()
    elif bad == "lse_dtype":
        lse = lse.double()
    with pytest.raises((ValueError, TypeError)):
        tfa.flash_attention_backward(q, k, v, out, lse, dout)


def test_backward_wrapper_on_cpu_is_the_plain_version():
    arrays = _arrays(1, 70, 90, 8, 8)
    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    out, lse = tfa.chunked_attention_lse(q, k, v)
    before = tfa.flash_attention_backward.launches
    got = tfa.flash_attention_backward(q, k, v, out, lse, g)
    for a, b in zip(got, tfa.attention_backward(q, k, v, out, lse, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tfa.flash_attention_backward.launches == before
