"""The port's weight bridge: JAX variables → the port's SlowFast and CMDA
state_dicts, held key for key against the JAX package's own exporter."""

import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.utils.torch_ckpt import export_torch_state_dict
from efficient_slowfast_tpu_torch.utils.weights import (
    _flatten, jax_variables_to_state_dict, state_dict_to_jax_variables)
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


CMDA = "SlowFastDualAttention"


@pytest.fixture(scope="module")
def cmda_variables():
    return jax_model_and_variables(inputs_np(small_cfg(model=CMDA), batch=1),
                                   model=CMDA)[1]


def test_cmda_converter_equals_export_torch_state_dict(cmda_variables):
    ours = jax_variables_to_state_dict(cmda_variables)
    theirs = export_torch_state_dict(cmda_variables["params"],
                                     cmda_variables["batch_stats"])
    ours = {k: v for k, v in ours.items()
            if not k.endswith("num_batches_tracked")}
    assert sorted(ours) == sorted(theirs)
    fuse = "s2_fuse.attention_"
    assert {fuse + "channel_f2s.conv.weight", fuse + "spatial_s2f.gamma",
            fuse + "spatial_s2f.query_conv.bias"} <= set(ours)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_cmda_converter_loads_strict_into_port_cmda(cmda_variables):
    _, model = port_model(cmda_variables, model=CMDA)  # strict=True inside
    sd = model.state_dict()
    att = cmda_variables["params"]["s1_fuse"]["attention_spatial_s2f"]
    np.testing.assert_array_equal(
        sd["s1_fuse.attention_spatial_s2f.gamma"].numpy(), att["gamma"])
    assert float(att["gamma"][0]) == 0.5
    eca = cmda_variables["params"]["s1_fuse"]["attention_channel_f2s"]
    np.testing.assert_array_equal(
        sd["s1_fuse.attention_channel_f2s.conv.weight"].numpy(),
        np.transpose(eca["conv"]["kernel"], (2, 1, 0)))


def test_cmda_inverse_round_trips(cmda_variables):
    sd = jax_variables_to_state_dict(cmda_variables)
    back = state_dict_to_jax_variables(sd)
    for coll in ("params", "batch_stats"):
        ref = _flatten(cmda_variables[coll])
        got = _flatten(back[coll])
        assert sorted(got) == sorted(ref)
        for path, v in ref.items():
            np.testing.assert_array_equal(got[path], v, err_msg=str(path))
    again = jax_variables_to_state_dict(back)
    assert sorted(again) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(again[k], sd[k], rtol=0, atol=0)
    model = build_model(small_cfg(model=CMDA), device="cpu")
    model.load_state_dict(again, strict=True)
