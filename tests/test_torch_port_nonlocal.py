"""The port's non-local block against the JAX package's on the same weights
(carried across by jax_variables_to_state_dict) and inputs, f32 on the CPU,
rtol = atol = 1e-4, with the block's final BN γ drawn around 1 (it
starts at 0, where the block adds nothing) and jittered BN statistics:
each branch (softmax above and at or below TPU.FLASH_MIN_TOKENS, and
dot_product), odd H and W under the (1, 2, 2) pool, a stage with
NONLOCAL.GROUP 2, the bf16 query scaling, and the gradients of a train-mode
step through the block against jax.grad."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.models.nonlocal_block import \
    Nonlocal as JaxNonlocal
from efficient_slowfast_tpu.models.resnet import ResStage as JaxResStage
from efficient_slowfast_tpu.ops.options import configure, options
from efficient_slowfast_tpu_torch.models.nonlocal_block import (
    Nonlocal, scaled_queries)
from efficient_slowfast_tpu_torch.models.resnet import ResStage
from efficient_slowfast_tpu_torch.ops.kernels import flash_attention as fa
from efficient_slowfast_tpu_torch.utils.weights import (
    jax_variables_to_state_dict, state_dict_to_jax_variables)
from torch_port_helpers import _jitter, _numpy_tree, flat_leaves, \
    nonlocal_params

TOL = dict(rtol=1e-4, atol=1e-4)
# (instantiation, flash_min_tokens, pool, (T, H, W)): 72 queries, 18 keys
CASES = {
    "softmax_flash": ("softmax", 16, (1, 2, 2), (2, 6, 6)),
    "softmax_dense": ("softmax", 1024, (1, 2, 2), (2, 6, 6)),
    "dot_product": ("dot_product", 16, (1, 2, 2), (2, 6, 6)),
    "softmax_flash_odd_hw": ("softmax", 16, (1, 2, 2), (2, 5, 7)),
    "softmax_flash_no_pool": ("softmax", 16, (1, 1, 1), (2, 3, 5)),
    "dot_product_odd_hw": ("dot_product", 16, (2, 2, 2), (3, 5, 7)),
}
DIM, INNER = 12, 6


@pytest.fixture(autouse=True)
def _restore_jax_options():
    yield
    configure(jax_get_cfg())  # JAX keeps its kernel options process-wide


def _to_port(x):  # (B, T, H, W, C) → the NCDHW channels-last view
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _from_port(y):
    return y.permute(0, 2, 3, 4, 1).detach().numpy()


def _biases(tree, rs):
    """Conv biases drawn from ``rs`` (they start at 0)."""
    return {k: _biases(v, rs) if hasattr(v, "items") else
            (0.1 * rs.randn(*v.shape)).astype(v.dtype) if k == "bias" and
            v.ndim == 1 and v.shape[0] != DIM else v
            for k, v in tree.items()}


def _variables(jmod, x):
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _biases(_numpy_tree(variables["params"]),
                     np.random.RandomState(5))
    return {"params": nonlocal_params(params, np.random.RandomState(6), True),
            "batch_stats": _jitter(_numpy_tree(variables["batch_stats"]),
                                   [0])}


def _pair(monkeypatch, case):
    instantiation, min_tokens, pool, (t, h, w) = CASES[case]
    monkeypatch.setattr(options, "flash_min_tokens", min_tokens)
    x = np.random.RandomState(3).randn(2, t, h, w, DIM).astype(np.float32)
    jmod = JaxNonlocal(dim_inner=INNER, pool_size=pool,
                       instantiation=instantiation)
    variables = _variables(jmod, x)
    port = Nonlocal(DIM, INNER, pool, instantiation,
                    flash_min_tokens=min_tokens)
    port.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return x, jmod, variables, port


@pytest.mark.parametrize("case", sorted(CASES))
def test_nonlocal_matches_jax(monkeypatch, case):
    x, jmod, variables, port = _pair(monkeypatch, case)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    calls = []
    chunked = fa.chunked_attention_lse
    monkeypatch.setattr(fa, "chunked_attention_lse",
                        lambda *a: calls.append(1) or chunked(*a))
    with torch.no_grad():
        out = _from_port(port.eval()(_to_port(x)))
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.abs(out - x).max() > 0.1  # the block reaches the output
    # the streaming branch, flash_attention's plain version on the CPU
    flash = CASES[case][0] == "softmax" and CASES[case][1] < 72
    assert len(calls) == int(flash)


@pytest.mark.parametrize("case", ["softmax_flash", "softmax_dense",
                                  "dot_product"])
def test_nonlocal_gradients_match_jax(monkeypatch, case):
    """One train-mode step (batch statistics) of sum(out · w): the
    gradients of every parameter and of the input."""
    x, jmod, variables, port = _pair(monkeypatch, case)
    w = np.random.RandomState(7).randn(*x.shape).astype(np.float32)

    def loss(params, xj):
        out, _ = jmod.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, xj,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * w)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        jnp.asarray(x))
    xt = _to_port(x).clone().requires_grad_(True)
    out = port.train()(xt)
    (out.permute(0, 2, 3, 4, 1) * torch.from_numpy(w)).sum().backward()
    grads = dict(port.state_dict())  # buffers mark the BNs for the bridge
    grads.update({k: p.grad for k, p in port.named_parameters()})
    got = flat_leaves(state_dict_to_jax_variables(grads)["params"])
    want = flat_leaves(_numpy_tree(g_params))
    assert set(got) == set(want)
    for key in sorted(want):
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_from_port(xt.grad), np.asarray(g_x),
                               rtol=1e-4, atol=1e-4)
    assert np.abs(want["theta/conv/kernel"]).max() > 1e-3


@pytest.mark.parametrize("group", [1, 2])
def test_stage_with_nonlocal_groups_matches_jax(monkeypatch, group):
    """A stage of two blocks, each followed by a non-local block; with
    NONLOCAL.GROUP 2 each block attends within two groups of consecutive
    frames, folded into the batch as JAX folds them."""
    monkeypatch.setattr(options, "flash_min_tokens", 16)
    x = np.random.RandomState(8).randn(2, 4, 6, 6, 16).astype(np.float32)
    kw = dict(temp_kernel_sizes=[[3]], stride=[1], num_blocks=[2],
              num_groups=[1], num_block_temp_kernel=[2],
              nonlocal_inds=[[0, 1]], nonlocal_group=[group],
              nonlocal_pool=[[1, 2, 2]], instantiation="softmax")
    jmod = JaxResStage(dim_out=[16], dim_inner=[4], **kw)
    variables = _variables(jmod, [x])
    ref = np.asarray(jmod.apply(variables, [jnp.asarray(x)])[0])
    port = ResStage(dim_in=[16], dim_out=[16], dim_inner=[4],
                    flash_min_tokens=16, **kw)
    port.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    with torch.no_grad():
        out = _from_port(port.eval()([_to_port(x)])[0])
    np.testing.assert_allclose(out, ref, **TOL)
    if group == 2:  # the fold changes the result
        flat = dict(kw, nonlocal_group=[1])
        other = ResStage(dim_in=[16], dim_out=[16], dim_inner=[4],
                         flash_min_tokens=16, **flat)
        other.load_state_dict(port.state_dict())
        with torch.no_grad():
            ungrouped = _from_port(other.eval()([_to_port(x)])[0])
        assert np.abs(ungrouped - out).max() > 1e-2


@pytest.mark.parametrize("dim_inner", [200, 256, 512])
def test_bf16_query_scaling_matches_jax(dim_inner):
    """θ · dim_inner^-½ in bfloat16, bit for bit: the scale rounds to
    bfloat16 before the product (512^-½ is not a power of two)."""
    theta = np.random.RandomState(9).randn(2, 64, dim_inner).astype(
        np.float32)
    ref = np.asarray((jnp.asarray(theta, jnp.bfloat16)
                      * dim_inner ** -0.5).astype(jnp.float32))
    got = scaled_queries(torch.from_numpy(theta).bfloat16(), dim_inner)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)
    if dim_inner == 512:  # the unrounded scale would give other bits
        exact = (torch.from_numpy(theta).bfloat16().float()
                 * 512 ** -0.5).bfloat16()
        assert not torch.equal(exact, got)
