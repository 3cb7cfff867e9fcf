"""The port's fused serving engine (make_forward with TPU.FUSED_EVAL) against
the JAX fused engine and the port's own module forward, f32 on the CPU,
where the kernel's plain version runs and no kernel is launched."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.engine.inference import (
    make_fused_eval_forward as jax_fused, supports as jax_supports)
from efficient_slowfast_tpu_torch.config import get_cfg as torch_get_cfg
from efficient_slowfast_tpu_torch.engine.inference import supports
from efficient_slowfast_tpu_torch.engine.state import make_forward
from efficient_slowfast_tpu_torch.ops.kernels.fused_bottleneck import \
    fused_bottleneck
from torch_port_helpers import (inputs_np, jax_model_and_variables,
                                port_model, small_cfg, torch_inputs)


@pytest.fixture(scope="module")
def setup():
    inputs = inputs_np(small_cfg())
    _, variables = jax_model_and_variables(inputs)
    ref = np.asarray(jax_fused(small_cfg(jax_get_cfg, fused=True))(
        variables, [jnp.asarray(x) for x in inputs]))
    return inputs, variables, ref


def test_fused_engine_matches_jax_and_module(setup):
    inputs, variables, ref = setup
    cfg, model = port_model(variables, fused=True)
    before = fused_bottleneck.launches
    fused = make_forward(cfg, model, device="cpu")(torch_inputs(inputs)).numpy()
    assert fused_bottleneck.launches == before  # plain version on the CPU
    cfg.TPU.FUSED_EVAL = False
    module = make_forward(cfg, model, device="cpu")(torch_inputs(inputs)).numpy()
    assert fused.shape == ref.shape == (2, 12)
    np.testing.assert_allclose(fused, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(fused, module, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(fused.sum(-1), 1.0, atol=1e-4)


def _variants(get_cfg):
    # the cases of tests/test_inference_engine.py:43-51, and more
    good = small_cfg(get_cfg)
    nonlocal_ = small_cfg(get_cfg)
    nonlocal_.NONLOCAL.LOCATION = [[[1], []]] + [[[], []]] * 3
    sub_bn = small_cfg(get_cfg)
    sub_bn.BN.NORM_TYPE = "sub_batchnorm"
    sigmoid = small_cfg(get_cfg)
    sigmoid.MODEL.HEAD_ACT = "sigmoid"
    basic = small_cfg(get_cfg)
    basic.RESNET.TRANS_FUNC = "basic_transform"
    return [good, nonlocal_, sub_bn, sigmoid, basic]


def test_supports_agrees_with_jax():
    ours = [supports(c) for c in _variants(torch_get_cfg)]
    theirs = [jax_supports(c) for c in _variants(jax_get_cfg)]
    assert ours == theirs == [True, False, False, False, False]


def test_make_forward_refuses_int8_with_fused():
    cfg = small_cfg(fused=True)
    cfg.TPU.INT8_EVAL = True
    with pytest.raises(AssertionError):
        make_forward(cfg, torch.nn.Identity(), device="cpu")
