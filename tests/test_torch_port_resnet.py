"""The port's single-pathway ResNet (C2D, I3D, Slow, Fast; depths 18, 50,
101; with and without non-local blocks) and the slow-pathway head against
the JAX package on the same weights (the port's seeded init carried across
by the weight bridge, BN statistics jittered, every non-local γ drawn around
1) and inputs, f32 on the CPU, rtol = atol = 1e-4: the eval forward, three
composed train steps of I3D-NLN-R50 at lr 0.01, and the weight bridge in
both directions, key for key against ``export_torch_state_dict``.

Crops are 64² (32² at R101), 8 frames: I3D-NLN's s3 blocks attend over 256
queries and its s4 blocks over 64, so with TPU.FLASH_MIN_TOKENS 128 s3 takes
the streaming branch (flash_attention, its plain version on the CPU) and
s4 the dense one, as at the full size's 224² (3136 and 784 queries against
the default 1024)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu.ops.options import configure
from efficient_slowfast_tpu.utils.torch_ckpt import export_torch_state_dict
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.ops.kernels import flash_attention as fa
from efficient_slowfast_tpu_torch.utils.weights import (
    jax_variables_to_state_dict, state_dict_to_jax_variables)
from torch_port_helpers import (NLN_R50, compiled, flat_leaves, inputs_np,
                                jax_train_runs, port_train_run,
                                seeded_variables, small_cfg, torch_inputs,
                                train_batches, train_cfg)

TOL = dict(rtol=1e-4, atol=1e-4)
NLN = dict(model="ResNet", nonlocal_loc=NLN_R50, flash_min_tokens=128)
# small_cfg keywords and cfg overrides of each architecture
ARCHS = {
    "i3d_nln_r50": (dict(NLN, arch="i3d"), {}),
    "c2d_nln_r50": (dict(NLN, arch="c2d"), {}),
    "slow_nln_r50": (dict(NLN, arch="slow"), {}),
    "fast_r50": (dict(model="ResNet", arch="fast"), {}),
    # the TIRED Slow-NLN R18 yamls' shape: s3 unstrided, dot_product blocks
    "slow_nln_r18_basic": (
        dict(model="ResNet", arch="slow", depth=18, trans="basic_transform",
             nonlocal_loc=[[], [1], [1], []], instantiation="dot_product"),
        {"RESNET.SPATIAL_STRIDES": [[1], [1], [2], [2]]}),
    # at 32² s3 attends over 64 queries, s4 over 16
    "i3d_nln_r101_w8": (dict(NLN, arch="i3d", depth=101, width=8,
                             flash_min_tokens=32), {"DATA.CROP_SIZE": 32}),
    # CMDA's is in test_torch_port_cmda.py
    "slowfast_slow_head": (dict(model="SlowFast"),
                           {"MODEL.SLOW_PATHWAY_HEAD": True}),
}


@pytest.fixture(autouse=True)
def _restore_jax_options():
    yield
    configure(jax_get_cfg())  # JAX keeps its kernel options process-wide


def _cfgs(name):
    kw, extra = ARCHS[name]
    cfgs = [small_cfg(**kw), small_cfg(jax_get_cfg, **kw)]
    for cfg in cfgs:
        for key, value in extra.items():
            node, leaf = key.split(".")
            setattr(getattr(cfg, node), leaf, value)
    return cfgs


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_eval_forward_matches_jax(name, monkeypatch):
    cfg, jcfg = _cfgs(name)
    variables = seeded_variables(cfg)
    inputs = inputs_np(cfg)
    jmodel = jax_build_model(jcfg)
    ref = np.asarray(compiled(lambda v, x: jmodel.apply(v, x, train=False),
                              variables, [jnp.asarray(x) for x in inputs]))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    calls = []
    chunked = fa.chunked_attention_lse
    monkeypatch.setattr(fa, "chunked_attention_lse",
                        lambda *a: calls.append(1) or chunked(*a))
    with torch.no_grad():
        out = model.eval()(torch_inputs(inputs)).numpy()
    assert out.shape == ref.shape == (2, 12)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-4)
    # I3D-NLN-R50's two s3 blocks take the streaming branch
    streaming = name in ("i3d_nln_r50", "c2d_nln_r50", "slow_nln_r50",
                         "i3d_nln_r101_w8")
    assert len(calls) == (2 if streaming else 0)
    if "slow_head" in name:  # the head reads the slow pathway alone
        assert model.head.projection.in_features == 16 * 32


def _zoo_resnet_and_nln_yamls():
    import glob
    import os

    import yaml

    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "Kinetics")
    out = []
    for path in sorted(glob.glob(os.path.join(root, "**", "*.yaml"),
                                 recursive=True)):
        with open(path) as f:
            text = f.read()
        model = (yaml.safe_load(text) or {}).get("MODEL", {})
        if model.get("MODEL_NAME") == "ResNet" or "NLN" in path:
            out.append(os.path.relpath(path, root))
    return out


@pytest.mark.parametrize("name", _zoo_resnet_and_nln_yamls())
def test_zoo_yaml_builds(name):
    """Every ``MODEL_NAME: ResNet`` and non-local yaml of
    configs/Kinetics builds (width 8 for speed; the shapes follow it)."""
    import os

    from efficient_slowfast_tpu_torch.config import load_cfg

    cfg = load_cfg(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "Kinetics", name))
    cfg.RESNET.WIDTH_PER_GROUP = 8
    model = build_model(cfg, device="cpu")
    nln = [n for n, _ in model.named_modules() if "_nonlocal" in n
           and n.count(".") == 1]
    assert bool(nln) == any(any(loc) for stage in cfg.NONLOCAL.LOCATION
                            for loc in stage)


def test_non_local_blocks_sit_where_the_yaml_puts_them():
    cfg, _ = _cfgs("i3d_nln_r50")
    model = build_model(cfg, device="cpu")
    nln = sorted(n for n, _ in model.named_modules() if "nonlocal" in n
                 and n.count(".") == 1)
    assert nln == ["s3.pathway0_nonlocal1", "s3.pathway0_nonlocal3",
                   "s4.pathway0_nonlocal1", "s4.pathway0_nonlocal3",
                   "s4.pathway0_nonlocal5"]
    block = model.s3.pathway0_nonlocal1
    assert block.conv_theta.out_channels == 16 * 8 // 2
    assert block.pool_size == [1, 2, 2]
    assert float(block.bn.weight.detach().abs().max()) == 0.0  # zero-init γ


@pytest.mark.parametrize("name", ["i3d_nln_r50", "slowfast_slow_head"])
def test_weight_bridge_both_directions_matches_export(name):
    """A JAX variable tree of the model (its shapes by ``eval_shape``,
    values drawn) → the port's state_dict, key for key and value for value
    the JAX package's ``export_torch_state_dict``, loaded strict; and the
    port's state_dict back to the same tree."""
    cfg, jcfg = _cfgs(name)
    jmodel = jax_build_model(jcfg)
    x = [jnp.asarray(a) for a in inputs_np(cfg, batch=1)]
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(0)}, x,
                            train=False))
    rs = np.random.RandomState(11)
    tree = jax.tree_util.tree_map(
        lambda s: rs.randn(*s.shape).astype(np.float32), shapes)
    tree = {k: jax.tree_util.tree_map(np.asarray, dict(tree[k]))
            for k in ("params", "batch_stats")}
    ours = jax_variables_to_state_dict(tree)
    theirs = export_torch_state_dict(tree["params"], tree["batch_stats"])
    ours = {k: v for k, v in ours.items()
            if not k.endswith("num_batches_tracked")}
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v),
                                      err_msg=k)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(tree), strict=True)
    back = flat_leaves(state_dict_to_jax_variables(model.state_dict()))
    want = flat_leaves(tree)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    if name == "i3d_nln_r50":
        assert "s3.pathway0_nonlocal1.conv_theta.bias" in ours
        assert "s4.pathway0_nonlocal5.bn.running_var" in ours


def test_three_i3d_nln_train_steps_match_jax(monkeypatch):
    """Three composed train steps at lr 0.01 (the yaml's warm-up start),
    as the reference trains: SGD nesterov 0.9, weight decay 1e-4 and none
    on BN, each block's final BN zero-initialised; every gradient of s3's
    blocks through the streaming branch's backward.

    Held as far as float32 repeats itself here, as
    ``test_torch_port_train.py`` holds its base-lr run: the three losses
    and the whole state after the second step. Inputs scaled by 1 + 1e-6
    move the port's own state by 0.01, 0.37 and 3.2 times the tolerance
    after steps 1, 2 and 3 (its third loss by 3.5e-5). The non-local γ are
    drawn around 0.1: around 1, five blocks each adding a unit-variance
    term make the run chaotic already at the second loss (the same
    perturbation moves it by 1.7e-4, the third by 0.3%)."""
    kw = dict(NLN, arch="i3d")
    batches = train_batches(train_cfg(**kw), steps=3)
    run = [(x, y, 0.01) for x, y in batches]
    variables = seeded_variables(train_cfg(**kw), nonlocal_gamma=0.1)
    [(jax_losses, jax_snaps, jax_mets)] = jax_train_runs(variables, [run],
                                                         **kw)
    calls = []
    bwd = fa.attention_backward
    monkeypatch.setattr(fa, "attention_backward",
                        lambda *a: calls.append(1) or bwd(*a))
    losses, snaps, mets, state = port_train_run(variables, run, **kw)
    np.testing.assert_allclose(losses, jax_losses, **TOL)
    got, want = flat_leaves(snaps[1]), flat_leaves(jax_snaps[1])
    assert set(got) == set(want)
    for key in sorted(want):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    assert state.step == 3
    for key in mets:
        assert mets[key] == pytest.approx(jax_mets[key], rel=1e-4), key
    assert len(calls) == 6  # two streaming blocks a step
    # the non-local blocks train: the two updates of θ, φ and g of s3's
    # blocks, 1e-4 of weights around 0.7 (γ 0.1 scales their gradient),
    # agree to 1% of their size, so a port without the affinity's
    # gradient would not match
    init = flat_leaves(variables)
    for i in (1, 3):
        for conv in ("theta", "phi", "g"):
            key = f"params/s3/pathway0_nonlocal{i}/{conv}/conv/kernel"
            step, ref = got[key] - init[key], want[key] - init[key]
            assert np.abs(ref).max() > 2e-5, key
            assert np.abs(step - ref).max() < 0.01 * np.abs(ref).max(), key
