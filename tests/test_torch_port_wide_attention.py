"""Attention wider than 512 (D or C), the port against the JAX package, on
the CPU: the flash-attention wrappers and their backward at five widths
above 512, a res5 non-local block (dim 1280, dim_inner 640), CMDA's
SpatialAttention at reduction 1 (c = 576), and a SlowFast whose slow res5
carries a softmax non-local block under AVA's res5 stride and dilation,
served and trained one SGD step. f32 at rtol = atol = 1e-4; bf16 against
JAX's bf16 at 2e-2 of the scale. The weights cross by the bridge and load
``strict=True``. JAX's references are jitted and compiled once each at
XLA's lowest backend optimisation (``compiled``), which compiles the
slice's train step in half the time; f32 results differ from the
optimised build's only in rounding.

On the CPU the wrappers run their plain versions, as JAX's
``flash_attention`` runs ``chunked_attention`` there; the CUDA kernels at
these widths (the cluster kernels) are held against the same plain
versions on the card by ``chip_smoke.py`` (phase 21)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.engine.state import TrainState as JaxTrainState
from efficient_slowfast_tpu.engine.state import \
    make_train_step as jax_make_train_step
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu.models.nonlocal_block import \
    Nonlocal as JaxNonlocal
from efficient_slowfast_tpu.models.optimizer import construct_optimizer
from efficient_slowfast_tpu.ops import attention as jattn
from efficient_slowfast_tpu.ops.options import configure, options
from efficient_slowfast_tpu.ops.pallas import flash_attention as jfa
from efficient_slowfast_tpu_torch.config import get_cfg as torch_get_cfg
from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                       make_train_step)
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.models.nonlocal_block import Nonlocal
from efficient_slowfast_tpu_torch.ops import attention as tattn
from efficient_slowfast_tpu_torch.ops.kernels import flash_attention as tfa
from efficient_slowfast_tpu_torch.utils.weights import (
    jax_variables_to_state_dict, state_dict_to_jax_variables)
from torch_port_helpers import (_jitter, _numpy_tree, attention_params,
                                compiled, flat_leaves, inputs_np,
                                nonlocal_params, seeded_variables,
                                torch_inputs, train_cfg)

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = 2e-2
# (B, N, M, D, C): N and M ragged against every tile of the kernels
WIDTHS = {"d513_c513": (2, 70, 45, 513, 513),
          "d600_c700": (1, 77, 19, 600, 700),
          "d1024_c1024": (1, 67, 33, 1024, 1024),
          "d64_c1100": (2, 50, 29, 64, 1100),
          "d1100_c64": (2, 41, 57, 1100, 64)}
# the logits' std (q and k each scaled by (std / √D)^½): a softmax that
# neither flattens nor collapses to an argmax
LOGIT_STD = 3.0


@pytest.fixture(autouse=True)
def _restore_jax_options():
    yield
    configure(jax_get_cfg())  # JAX keeps its kernel options process-wide


def _qkv(b, n, m, d, c, seed=0):
    rs = np.random.RandomState(seed)
    f = np.float32((LOGIT_STD / d ** 0.5) ** 0.5)
    return (rs.randn(b, n, d).astype(np.float32) * f,
            rs.randn(b, m, d).astype(np.float32) * f,
            rs.randn(b, m, c).astype(np.float32),
            rs.randn(b, n, c).astype(np.float32))


def _forward_and_vjp(q, k, v, g):
    out, vjp = jax.vjp(jfa.flash_attention, q, k, v)
    return (out,) + vjp(g)


@functools.lru_cache(maxsize=None)
def jax_attention(case, dtype=jnp.float32):
    """The inputs of ``case`` (numpy f32) and JAX's output and vjp, (out,
    dq, dk, dv) in float32, for inputs in ``dtype``: one compile a case."""
    arrays = _qkv(*WIDTHS[case])
    got = compiled(_forward_and_vjp, *(jnp.asarray(a, dtype) for a in arrays))
    return arrays, [np.asarray(x.astype(jnp.float32)) for x in got]


@pytest.mark.parametrize("case", sorted(WIDTHS))
def test_wide_wrappers_match_jax(case):
    """flash_attention, plain_attention (no autograd) and the forward's
    log-sum-exp path at D or C above 512 against JAX's flash_attention."""
    (q, k, v, _), (ref, *_) = jax_attention(case)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    for fn in (tfa.flash_attention, tfa.plain_attention):
        out = fn(*t)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
    out, lse = tfa._forward(*t, with_lse=True)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert lse.shape == ref.shape[:2]


@pytest.mark.parametrize("case", sorted(WIDTHS))
def test_wide_backward_matches_jax_vjp(case):
    """flash_attention_backward from the forward's output and lse, and
    autograd through flash_attention and plain_attention, against
    jax.vjp of JAX's flash_attention."""
    (q, k, v, g), (ref, *want) = jax_attention(case)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out, lse = tfa._forward(*t, with_lse=True)
    got = tfa.flash_attention_backward(*t, out, lse, torch.from_numpy(g))
    for x, w in zip(got, want):
        np.testing.assert_allclose(x.numpy(), w, **TOL)
    for fn in (tfa.flash_attention, tfa.plain_attention):
        leaves = [a.clone().requires_grad_() for a in t]
        out = fn(*leaves)
        assert out.grad_fn is not None
        np.testing.assert_allclose(out.detach().numpy(), ref, **TOL)
        out.backward(torch.from_numpy(g))
        for x, w in zip(leaves, want):
            np.testing.assert_allclose(x.grad.numpy(), w, **TOL)
    assert np.abs(want[0]).max() > 1e-2  # the gradients are not vanishing


@pytest.mark.parametrize("case", ["d600_c700", "d1024_c1024"])
def test_wide_bf16_matches_jax_bf16(case):
    """bfloat16 inputs: the output and the three gradients against JAX's
    bf16 flash_attention and its vjp, within 2e-2 of each one's scale
    (both compute in float32 and round once to bf16)."""
    (q, k, v, g), want = jax_attention(case, jnp.bfloat16)
    leaves = [torch.from_numpy(a).bfloat16().requires_grad_()
              for a in (q, k, v)]
    out = tfa.flash_attention(*leaves)
    out.backward(torch.from_numpy(g).bfloat16())
    for x, w in zip([out] + [t.grad for t in leaves], want):
        assert x.dtype == torch.bfloat16
        err = np.abs(x.detach().float().numpy() - w).max()
        assert err <= BF16_TOL * max(1.0, np.abs(w).max()), err


def test_fake_op_and_flop_count_at_wide_widths():
    """The op that a torch.export graph holds, ``esf_torch::flash_attention``,
    traced by fake tensors as export traces it, and the flop counter's
    formula for it (``utils/misc.py``) at D = C = 1024: the output and lse
    shapes, and 2 · B · N · M · (D + C)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from efficient_slowfast_tpu_torch.utils.misc import register_kernel_flops

    b, n, m, d, c = WIDTHS["d1024_c1024"]
    with FakeTensorMode():
        out, lse = torch.ops.esf_torch.flash_attention(
            torch.empty(b, n, d), torch.empty(b, m, d), torch.empty(b, m, c),
            True)
    assert out.shape == (b, n, c) and lse.shape == (b, n)
    register_kernel_flops()
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(b, n, m, d, c))
    with FlopCounterMode(display=False) as counter:
        tfa.flash_attention(q, k, v)
    assert counter.get_total_flops() == 2 * b * n * m * (d + c)


# -- a res5 non-local block ---------------------------------------------------
NL_DIM, NL_INNER = 1280, 640


def _to_port(x):  # (B, T, H, W, C) → the NCDHW channels-last view
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _from_port(y):
    return y.permute(0, 2, 3, 4, 1).detach().numpy()


def _drawn_biases(tree, rs, skip):
    """Conv biases drawn from ``rs`` (they start at 0), but not those of
    width ``skip``."""
    return {k: _drawn_biases(v, rs, skip) if hasattr(v, "items") else
            (0.1 * rs.randn(*v.shape)).astype(v.dtype) if k == "bias" and
            v.ndim == 1 and v.shape[0] != skip else v
            for k, v in tree.items()}


def _grads_of(port):
    grads = dict(port.state_dict())  # buffers mark the BNs for the bridge
    grads.update({k: p.grad for k, p in port.named_parameters()})
    return flat_leaves(state_dict_to_jax_variables(grads)["params"])


def test_res5_nonlocal_matches_jax(monkeypatch):
    """A softmax non-local block at a res5's width (dim 1280, dim_inner
    640, pool 1 x 2 x 2) on the streaming branch: the eval output, and the
    gradients of a train-mode step's sum(out · w) with respect to every
    parameter and the input, against JAX. The loss weights w have std 0.1,
    so that the gradients are of order 1: with unit w the output conv's
    kernel gradient sums 144 positions into entries near 25, where the two
    packages' float32 summation orders alone differ by 1.4e-4."""
    monkeypatch.setattr(options, "flash_min_tokens", 16)
    x = np.random.RandomState(3).randn(2, 2, 6, 6, NL_DIM).astype(np.float32)
    jmod = JaxNonlocal(dim_inner=NL_INNER, pool_size=(1, 2, 2),
                       instantiation="softmax")
    init = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _drawn_biases(_numpy_tree(init["params"]),
                           np.random.RandomState(5), NL_DIM)
    variables = {"params": nonlocal_params(params, np.random.RandomState(6),
                                           True),
                 "batch_stats": _jitter(_numpy_tree(init["batch_stats"]),
                                        [0])}
    port = Nonlocal(NL_DIM, NL_INNER, (1, 2, 2), "softmax",
                    flash_min_tokens=16)
    port.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    calls = []
    plain = tfa.chunked_attention_lse
    monkeypatch.setattr(tfa, "chunked_attention_lse",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    ref = np.asarray(compiled(jmod.apply, variables, jnp.asarray(x)))
    with torch.no_grad():
        out = _from_port(port.eval()(_to_port(x)))
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.abs(out - x).max() > 0.1  # the block reaches the output
    assert calls == [(2, 72, NL_INNER)]  # the streaming branch at D = 640

    w = 0.1 * np.random.RandomState(7).randn(*x.shape).astype(np.float32)

    def loss(p, xj):
        o, _ = jmod.apply({"params": p,
                           "batch_stats": variables["batch_stats"]}, xj,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(o * w)

    g_params, g_x = compiled(
        jax.grad(loss, argnums=(0, 1)),
        jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        jnp.asarray(x))
    xt = _to_port(x).clone().requires_grad_(True)
    (port.train()(xt).permute(0, 2, 3, 4, 1)
     * torch.from_numpy(w)).sum().backward()
    got, want = _grads_of(port), flat_leaves(_numpy_tree(g_params))
    assert set(got) == set(want)
    for key in sorted(want):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    np.testing.assert_allclose(_from_port(xt.grad), np.asarray(g_x), **TOL)
    assert np.abs(want["theta/conv/kernel"]).max() > 1e-3


def test_spatial_attention_at_reduction_1_matches_jax(monkeypatch):
    """CMDA's SpatialAttention at reduction 1 and c = 576 (D = C = 576,
    as a fuse of that width calls it), streaming: output and gradients."""
    c = 576
    monkeypatch.setattr(options, "flash_min_tokens", 16)
    x = np.random.RandomState(4).randn(2, 2, 5, 7, c).astype(np.float32)
    jmod = jattn.SpatialAttention(reduction=1)
    init = jax.jit(jmod.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    params = attention_params(_numpy_tree(init["params"]),
                              np.random.RandomState(8), inside=True)
    # q and k scaled so that the logits have std ~3 (at init ~20)
    for name in ("query", "key"):
        params[name]["conv"]["kernel"] = params[name]["conv"]["kernel"] * 0.35
    variables = {"params": params}
    port = tattn.SpatialAttention(c, reduction=1, flash_min_tokens=16)
    port.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    ref = np.asarray(compiled(jmod.apply, variables, jnp.asarray(x)))
    xt = _to_port(x).clone().requires_grad_(True)
    out = port(xt)
    np.testing.assert_allclose(_from_port(out), ref, **TOL)
    assert np.abs(ref - x).max() > 0.1

    w = 0.1 * np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    g_params, g_x = compiled(
        jax.grad(lambda p, xj: jnp.sum(jmod.apply({"params": p}, xj) * w),
                 argnums=(0, 1)),
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    (out.permute(0, 2, 3, 4, 1) * torch.from_numpy(w)).sum().backward()
    # a top-level parameter's path starts with "/" out of the bridge
    got = {k.lstrip("/"): g for k, g in flat_leaves(
        state_dict_to_jax_variables({k: p.grad for k, p in
                                     port.named_parameters()})["params"]
    ).items()}
    want = flat_leaves(_numpy_tree(g_params))
    assert set(got) == set(want)
    for key in sorted(want):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    np.testing.assert_allclose(_from_port(xt.grad), np.asarray(g_x), **TOL)


# -- the slice at a small depth -----------------------------------------------
def slice_cfg(get_cfg):
    """SlowFast with R18's stage depths of bottlenecks at width 40 (res5
    1280 wide, its non-local block's dim_inner 640), AVA's res5 (stride 1,
    dilation 2), one softmax non-local block after block 1 of the slow
    res5 (pool 1 x 2 x 2), a 32² crop (8 slow tokens there, over
    TPU.FLASH_MIN_TOKENS 4), trained at lr 0.01 as the train tests do."""
    cfg = train_cfg(get_cfg, depth=18, width=40, flash_min_tokens=4)
    cfg.RESNET.SPATIAL_STRIDES = [[1, 1], [2, 2], [2, 2], [1, 1]]
    cfg.RESNET.SPATIAL_DILATIONS = [[1, 1], [1, 1], [1, 1], [2, 2]]
    cfg.NONLOCAL.LOCATION = [[[], []], [[], []], [[], []], [[1], []]]
    cfg.DATA.CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = 32
    return cfg


@pytest.fixture(scope="module")
def wide_slice():
    cfg = slice_cfg(jax_get_cfg)
    variables = seeded_variables(slice_cfg(torch_get_cfg), seed=3,
                                 nonlocal_gamma=0.5)
    inputs = inputs_np(cfg, batch=2, seed=11)
    labels = np.random.RandomState(12).randint(0, 12, 2)
    model = jax_build_model(cfg)
    x = [jnp.asarray(a) for a in inputs]
    scores = np.asarray(compiled(
        functools.partial(model.apply, train=False), variables, x))
    # the optimizer built under jit: its state's eager init takes seconds
    made = {}

    def optimizer_state(params):
        made["tx"], opt_state = construct_optimizer(cfg, params)
        return opt_state

    opt_state = jax.jit(optimizer_state)(variables["params"])
    tx = made["tx"]
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=opt_state)
    state, mets = compiled(jax_make_train_step(cfg, model, tx), state, x,
                           jnp.asarray(labels), 0.01, jax.random.PRNGKey(0))
    after = _numpy_tree({"params": state.params,
                         "batch_stats": state.batch_stats})
    return variables, inputs, labels, scores, float(mets["loss"]), after


def _port_slice(variables):
    cfg = slice_cfg(torch_get_cfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return cfg, model


def test_slice_eval_scores_match_jax(wide_slice, monkeypatch):
    variables, inputs, _, scores, _, _ = wide_slice
    calls = []
    plain = tfa.chunked_attention_lse
    monkeypatch.setattr(tfa, "chunked_attention_lse",
                        lambda *a: calls.append(tuple(a[0].shape) +
                                                (a[2].shape[-1],))
                        or plain(*a))
    _, model = _port_slice(variables)
    with torch.no_grad():
        out = model.eval()(torch_inputs(inputs)).numpy()
    assert out.shape == scores.shape == (2, 12)
    np.testing.assert_allclose(out, scores, **TOL)
    # the res5 block's one call: 8 queries of width 640 against 2 keys
    assert calls == [(2, 8, 640, 640)]


def test_slice_sgd_step_matches_jax(wide_slice):
    variables, inputs, labels, _, loss, after = wide_slice
    cfg, model = _port_slice(variables)
    state = create_train_state(cfg, model, device="cpu")
    mets = make_train_step(cfg, state.model, state.optimizer)(
        state, torch_inputs(inputs), torch.from_numpy(labels), 0.01, None)
    np.testing.assert_allclose(float(mets["loss"]), loss, **TOL)
    got = flat_leaves(state_dict_to_jax_variables(
        {k: v.detach() for k, v in state.model.state_dict().items()}))
    want = flat_leaves(after)
    assert set(got) == set(want)
    for key in sorted(want):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    moved = flat_leaves(variables)
    nl = [k for k in want if "nonlocal" in k and k.endswith("kernel")]
    assert nl and any(np.abs(want[k] - moved[k]).max() > 0 for k in nl)
