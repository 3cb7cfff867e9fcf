"""The port's SlowFast eval forward against the JAX model on the same
weights (carried across by jax_variables_to_state_dict) and inputs, f32 on
the CPU, at the tolerance of tests/test_inference_engine.py:90-91; and the
port's config copy against the JAX package's on the YAML zoo."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu_torch.config import get_cfg
from torch_port_helpers import (compiled, inputs_np,
                                jax_model_and_variables, port_model,
                                small_cfg, torch_inputs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = {"r50_bottleneck": dict(depth=50, trans="bottleneck_transform"),
         "r18_basic": dict(depth=18, trans="basic_transform")}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def setup(request):
    kw = ARCHS[request.param]
    inputs = inputs_np(small_cfg())
    model, variables = jax_model_and_variables(inputs, **kw)
    ref = np.asarray(compiled(lambda v, x: model.apply(v, x, train=False),
                              variables, [jnp.asarray(x) for x in inputs]))
    return inputs, variables, ref, kw


def test_port_slowfast_eval_matches_jax(setup):
    inputs, variables, ref, kw = setup
    _, model = port_model(variables, **kw)
    with torch.no_grad():
        out = model(torch_inputs(inputs)).numpy()
    assert out.shape == ref.shape == (2, 12)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-4)


def test_port_slowfast_train_mode_returns_logits(setup):
    inputs, variables, _, kw = setup
    _, model = port_model(variables, **kw)
    model.train()
    with torch.no_grad():
        out = model(torch_inputs(inputs))
    assert out.shape == (2, 12) and torch.isfinite(out).all()
    assert not torch.allclose(out.sum(-1), torch.ones(2))


def test_config_zoo_merges_as_in_jax():
    files = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                             recursive=True))
    assert len(files) > 50
    for path in files:
        ours, theirs = get_cfg(), jax_get_cfg()
        ours.merge_from_file(path)
        theirs.merge_from_file(path)
        assert ours.to_dict() == theirs.to_dict(), path


def test_cli_overrides_merge_as_in_jax():
    opts = ["SOLVER.BASE_LR", "1e-4", "TRAIN.ENABLE", "False",
            "RESNET.SPATIAL_STRIDES", "[[1, 1], [2, 2], [2, 2], [2, 2]]",
            "DATA.PATH_TO_DATA_DIR", "/data/k400", "SOLVER.STEPS",
            "[0, 10, 20]", "TPU.COMPUTE_DTYPE", "float32", "NUM_GPUS", "2"]
    ours, theirs = get_cfg(), jax_get_cfg()
    ours.merge_from_list(opts)
    theirs.merge_from_list(opts)
    assert ours.to_dict() == theirs.to_dict()
    with pytest.raises(KeyError):
        ours.merge_from_list(["TPU.NO_SUCH_KEY", "1"])
