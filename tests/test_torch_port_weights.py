"""The port's weight bridge: JAX variables → the port's SlowFast state_dict,
held key for key against the JAX package's own exporter."""

import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.utils.torch_ckpt import export_torch_state_dict
from efficient_slowfast_tpu_torch.utils.weights import (
    jax_variables_to_state_dict, state_dict_to_jax_variables)
from torch_port_helpers import (inputs_np, jax_model_and_variables,
                                port_model, small_cfg)
from efficient_slowfast_tpu_torch.models import build_model


@pytest.fixture(scope="module")
def variables():
    return jax_model_and_variables(inputs_np(small_cfg(), batch=1))[1]


def test_converter_loads_strict_into_port_slowfast(variables):
    _, model = port_model(variables)  # load_state_dict(strict=True) inside
    sd = model.state_dict()
    bn = [k for k in sd if k.endswith("num_batches_tracked")]
    assert bn and all(int(sd[k]) == 0 for k in bn)
    np.testing.assert_array_equal(
        sd["s2.pathway0_res0.branch2.a.weight"].numpy(),
        np.transpose(variables["params"]["s2"]["pathway0_res0"]["branch2"]
                     ["a"]["conv"]["kernel"], (4, 3, 0, 1, 2)))


def test_converter_equals_export_torch_state_dict(variables):
    ours = jax_variables_to_state_dict(variables)
    theirs = export_torch_state_dict(variables["params"],
                                     variables["batch_stats"])
    ours = {k: v for k, v in ours.items()
            if not k.endswith("num_batches_tracked")}
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_inverse_round_trips_the_port_state_dict():
    model = build_model(small_cfg(), device="cpu")
    sd = model.state_dict()
    back = jax_variables_to_state_dict(state_dict_to_jax_variables(sd))
    assert sorted(back) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0,
                                   check_dtype=False)
