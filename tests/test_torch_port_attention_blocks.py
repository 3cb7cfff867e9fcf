"""The port's library attention blocks (ChannelAttention, NonLocalBlock,
StripeNonLocalBlock, ContextBlock3D) against the JAX package's over their
options, on the same weights (every parameter drawn, so that the zero-init
output layers reach the output; BN statistics jittered) and inputs, f32 on
the CPU, rtol = atol = 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.ops import attention as jattn
from efficient_slowfast_tpu_torch.ops import attention as tattn
from efficient_slowfast_tpu_torch.utils.weights import \
    jax_variables_to_state_dict
from torch_port_helpers import _jitter, _numpy_tree

TOL = dict(rtol=1e-4, atol=1e-4)
C = 16
# name: (JAX module, port module, input (T, H, W))
BLOCKS = {
    "channel_r16": (jattn.ChannelAttention(), tattn.ChannelAttention(C),
                    (2, 5, 5)),
    "channel_r4": (jattn.ChannelAttention(reduction=4),
                   tattn.ChannelAttention(C, reduction=4), (2, 5, 5)),
    "nonlocal_soft": (jattn.NonLocalBlock(), tattn.NonLocalBlock(C),
                      (2, 4, 6)),
    "nonlocal_dot_subsample": (
        jattn.NonLocalBlock(instance="dot", sub_sample=True,
                            inter_channels=6),
        tattn.NonLocalBlock(C, inter_channels=6, sub_sample=True,
                            instance="dot"), (2, 4, 6)),
    "nonlocal_soft_no_bn": (
        jattn.NonLocalBlock(bn_layer=False, sub_sample=True),
        tattn.NonLocalBlock(C, sub_sample=True, bn_layer=False), (2, 5, 7)),
    "stripe_mean_soft": (jattn.StripeNonLocalBlock(stripe=4),
                         tattn.StripeNonLocalBlock(C, 4), (2, 8, 5)),
    "stripe_max_dot": (
        jattn.StripeNonLocalBlock(stripe=2, pool_type="max", instance="dot"),
        tattn.StripeNonLocalBlock(C, 2, pool_type="max", instance="dot"),
        (3, 6, 4)),
    "stripe_meanmax_soft": (
        jattn.StripeNonLocalBlock(stripe=4, pool_type="meanmax",
                                  inter_channels=4),
        tattn.StripeNonLocalBlock(C, 4, inter_channels=4,
                                  pool_type="meanmax"), (2, 8, 3)),
    "context_att_add": (jattn.ContextBlock3D(), tattn.ContextBlock3D(C),
                        (2, 4, 5)),
    "context_avg_mul": (
        jattn.ContextBlock3D(pooling_type="avg", ratio=0.5,
                             fusion_types=("channel_mul",)),
        tattn.ContextBlock3D(C, ratio=0.5, pooling_type="avg",
                             fusion_types=("channel_mul",)), (2, 4, 5)),
    "context_att_mul_add": (
        jattn.ContextBlock3D(ratio=0.25,
                             fusion_types=("channel_mul", "channel_add")),
        tattn.ContextBlock3D(C, ratio=0.25,
                             fusion_types=("channel_mul", "channel_add")),
        (2, 4, 5)),
}


def _drawn(tree, rs):
    return {k: _drawn(v, rs) if hasattr(v, "items") else
            (0.3 * rs.randn(*np.shape(v))).astype(np.float32)
            for k, v in tree.items()}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    jmod, port, (t, h, w) = BLOCKS[name]
    rs = np.random.RandomState(sorted(BLOCKS).index(name))
    x = rs.randn(2, t, h, w, C).astype(np.float32)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": _drawn(_numpy_tree(variables["params"]), rs),
                 "batch_stats": _jitter(_numpy_tree(
                     variables.get("batch_stats", {})), [0])}
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    state = jax_variables_to_state_dict(variables)
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    out = out.permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.abs(out - x).max() > 1e-2  # the block reaches the output


def test_stripe_block_refuses_a_height_the_stripes_do_not_divide():
    block = tattn.StripeNonLocalBlock(C, 3)
    with pytest.raises(ValueError, match="stripes"):
        block(torch.zeros(1, C, 2, 8, 4))
