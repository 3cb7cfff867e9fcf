"""Checkpoint imports that the zoo's ResNets name, in the port and in the
JAX package (``utils/torch_ckpt.py::load_torch_checkpoint``) from the same
file into the same starting weights of an I3D-NLN-R50 (width 8): a Caffe2
model-zoo pickle (``CHECKPOINT_TYPE caffe2``, built as
tests/test_torch_ckpt.py builds one: stem, res blocks, projection, a
non-local block's convs and BN, the head, a momentum blob and a blob of the
wrong shape) and a 2-D ImageNet state dict inflated to 3-D
(``TRAIN.CHECKPOINT_INFLATE``). The parameters and statistics after the
load must be equal, bit for bit. Nothing is downloaded."""

import pickle

import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.utils.torch_ckpt import load_torch_checkpoint
from efficient_slowfast_tpu_torch.engine.state import create_train_state
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.utils import checkpoint as cu
from efficient_slowfast_tpu_torch.utils.weights import (
    jax_variables_to_state_dict, state_dict_to_jax_variables)
from torch_port_helpers import NLN_R50, flat_leaves, seeded_variables, \
    small_cfg

KW = dict(model="ResNet", arch="i3d", nonlocal_loc=NLN_R50, width=8)


@pytest.fixture(scope="module")
def variables():
    return seeded_variables(small_cfg(**KW))


def _port(cfg, variables):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return model


def _assert_equal_trees(model, params, batch_stats):
    got = flat_leaves(state_dict_to_jax_variables(model.state_dict()))
    want = flat_leaves({"params": params, "batch_stats": batch_stats})
    assert set(got) == set(want)
    for key in sorted(want):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _c2_blobs(model, rs):
    sd = model.state_dict()

    def like(name, scale=1.0):
        return (scale * rs.randn(*sd[name].shape)).astype(np.float32)

    nl = "s3.pathway0_nonlocal1"
    blobs = {
        "conv1_w": like("s1.pathway0_stem.conv.weight"),
        "res_conv1_bn_s": like("s1.pathway0_stem.bn.weight"),
        "res_conv1_bn_b": like("s1.pathway0_stem.bn.bias"),
        "res_conv1_bn_rm": like("s1.pathway0_stem.bn.running_mean"),
        "res_conv1_bn_riv": np.abs(like("s1.pathway0_stem.bn.running_var")),
        "res2_0_branch2a_w": like("s2.pathway0_res0.branch2.a.weight"),
        "res2_0_branch2a_bn_s": like("s2.pathway0_res0.branch2.a_bn.weight"),
        "res2_0_branch2a_bn_rm":
            like("s2.pathway0_res0.branch2.a_bn.running_mean"),
        "res3_1_branch2c_w": like("s3.pathway0_res1.branch2.c.weight"),
        "res2_0_branch1_w": like("s2.pathway0_res0.branch1.weight"),
        "res2_0_branch1_bn_b": like("s2.pathway0_res0.branch1_bn.bias"),
        "nonlocal_conv3_1_bn_s": like(nl + ".bn.weight"),
        "nonlocal_conv3_1_bn_riv": np.abs(like(nl + ".bn.running_var")),
        "pred_w": like("head.projection.weight"),
        "pred_b": like("head.projection.bias"),
        # momentum blobs are skipped; a shape that does not fit is kept out
        "conv1_w_momentum": np.zeros_like(like("s1.pathway0_stem.conv.weight")),
        "res2_1_branch2b_w": rs.randn(3, 3, 1, 3, 3).astype(np.float32),
    }
    for conv in ("theta", "phi", "g", "out"):
        blobs[f"nonlocal_conv3_1_{conv}_w"] = like(f"{nl}.conv_{conv}.weight")
        blobs[f"nonlocal_conv3_1_{conv}_b"] = like(f"{nl}.conv_{conv}.bias")
    return blobs


def test_caffe2_pickle_loads_as_in_jax(variables, tmp_path):
    cfg = small_cfg(**KW)
    model = _port(cfg, variables)
    blobs = _c2_blobs(model, np.random.RandomState(0))
    path = tmp_path / "c2_model.pkl"
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    params, batch_stats = load_torch_checkpoint(
        small_cfg(jax_get_cfg, **KW), str(path), variables["params"],
        variables["batch_stats"], caffe2=True)
    cfg.TEST.CHECKPOINT_FILE_PATH = str(path)
    cfg.TEST.CHECKPOINT_TYPE = "caffe2"
    cu.load_test_checkpoint(cfg, model)
    _assert_equal_trees(model, params, batch_stats)
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["s3.pathway0_nonlocal1.conv_theta.weight"].numpy(),
        blobs["nonlocal_conv3_1_theta_w"])
    np.testing.assert_array_equal(sd["head.projection.bias"].numpy(),
                                  blobs["pred_b"])
    assert sd["s2.pathway0_res1.branch2.b.weight"].shape[0] != 3


def test_c2_names_translate_as_in_jax():
    from efficient_slowfast_tpu.utils.torch_ckpt import \
        c2_name_to_torch as jax_c2_name_to_torch

    names = ["conv1_w", "res_conv1_bn_riv", "res4_5_branch2c_bn_s",
             "res3_0_branch1_w", "res3_0_branch1_bn_rm",
             "nonlocal_conv4_5_out_b", "nonlocal_conv3_1_g_w",
             "nonlocal_conv3_3_bn_b", "pred_w", "pred_b", "lr", "other_blob"]
    assert [cu.c2_name_to_torch(n) for n in names] == \
        [jax_c2_name_to_torch(n) for n in names]


def test_inflated_2d_weights_load_as_in_jax(variables, tmp_path):
    cfg = small_cfg(**KW)
    model = _port(cfg, variables)
    rs = np.random.RandomState(1)
    flat = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        shape = t.shape[:2] + t.shape[3:] if t.dim() == 5 else t.shape
        flat[name] = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    path = tmp_path / "imagenet_2d.pyth"
    torch.save({"model_state": flat}, path)
    params, batch_stats = load_torch_checkpoint(
        small_cfg(jax_get_cfg, **KW), str(path), variables["params"],
        variables["batch_stats"], inflate=True)
    cfg.TRAIN.CHECKPOINT_FILE_PATH = str(path)
    cfg.TRAIN.CHECKPOINT_INFLATE = True
    state = create_train_state(cfg, model, device="cpu")
    state, epoch = cu.load_train_checkpoint(cfg, state)
    assert epoch == 0
    _assert_equal_trees(state.model, params, batch_stats)
    # the stem's (O, 3, 7, 7) became (O, 3, 5, 7, 7) over I3D's kT 5
    w = state.model.state_dict()["s1.pathway0_stem.conv.weight"]
    assert w.shape[2] == 5
    np.testing.assert_array_equal(
        w[:, :, 2].numpy(),
        flat["s1.pathway0_stem.conv.weight"].numpy() / np.float32(5.0))
