"""The port's efficient families (SlowFastShuffleNetV2, SlowFastShuffleNet,
SlowFastMoibleNetV2, SlowFastGhostNet) and their shared blocks against the
JAX package on the same weights, carried across by the weight bridge with
the families' name table, and the same inputs, f32 on the CPU.

Each family runs at its zoo width (ShuffleNetV2 w2.0, ShuffleNet w2.0 g3 at
crop 64, MobileNetV2 w1.0, GhostNet w1.0), 8 frames, crop 32, batch 2, with
every attention γ 0.5, seeded attention biases, the query and key convs
scaled so that each fusion's logits have std 3 (at init they reach std
50-400, a near-argmax softmax where a rounding flips which key wins),
jittered BN statistics, and TPU.FLASH_MIN_TOKENS lowered to 16, so that the
fusions of more than 16 slow tokens take the streaming path on both sides
(flash_attention's plain version here, chunked_attention in JAX). Eval
scores are held at rtol = atol = 1e-4 of their scale: probabilities for
three families, and for GhostNet the mean of ReLU(logits), which reach the
hundreds on these weights; train-mode logits and the BN running statistics
they update at rtol 1e-3, atol 2e-3, the tolerances of
tests/test_full_model_parity.py for these families (about 60 BN layers of
float32 batch statistics in another summation order). Each family's two JAX
forwards compile as one function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu.models import common_efficient as jce
from efficient_slowfast_tpu.models import ghostnet as jghost
from efficient_slowfast_tpu.ops import pool as jpool
from efficient_slowfast_tpu.ops.options import configure
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.models import common_efficient as ce
from efficient_slowfast_tpu_torch.models.ghostnet import (GhostModule,
                                                          SqueezeExcite)
from efficient_slowfast_tpu_torch.ops import pool
from efficient_slowfast_tpu_torch.ops.kernels import flash_attention as fa
from efficient_slowfast_tpu_torch.utils.weights import (
    jax_variables_to_state_dict, state_dict_to_jax_variables)
from torch_port_helpers import (EFFICIENT, calibrate_fusions, compiled,
                                efficient_cfg, efficient_variables,
                                flat_leaves, inputs_np, torch_inputs)

TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN_TOL = dict(rtol=1e-3, atol=2e-3)


@pytest.fixture(autouse=True)
def _restore_jax_options():
    yield
    configure(jax_get_cfg())  # JAX keeps its kernel options process-wide


def _to_port(x):  # (B, T, H, W, C) → the NCDHW channels-last view
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _from_port(y):
    return y.permute(0, 2, 3, 4, 1).detach().numpy()


def _channels_last(y):
    return y.is_contiguous(memory_format=torch.channels_last_3d)


@pytest.mark.parametrize("groups", [2, 3])
def test_channel_shuffle_matches_jax(groups):
    x = np.random.RandomState(groups).randn(2, 3, 4, 5, 4 * groups).astype(
        np.float32)
    out = ce.channel_shuffle(_to_port(x), groups)
    np.testing.assert_array_equal(
        _from_port(out), np.asarray(jce.channel_shuffle(jnp.asarray(x),
                                                        groups)))
    assert _channels_last(out)


def test_shuffle_cat_is_cat_then_shuffle():
    rs = np.random.RandomState(0)
    a, b = (rs.randn(2, 3, 4, 5, 6).astype(np.float32) for _ in range(2))
    out = ce.shuffle_cat(_to_port(a), _to_port(b))
    want = jce.channel_shuffle(jnp.concatenate([a, b], axis=-1), 2)
    np.testing.assert_array_equal(_from_port(out), np.asarray(want))
    assert _channels_last(out)


def test_make_divisible_matches_jax_at_ghostnet_widths():
    """Every width GhostNet rounds (hidden and out channels of each row,
    the stem, the SE reduction) at widths 0.5-2.0 and β 4 and 8, with the
    float floor division of the fast pathway."""
    values = {16 * 1.0}
    for stage in jghost._GHOST_STAGE_CFGS:
        for _, t, c, se, _ in stage:
            for wm in (0.5, 1.0, 1.3, 2.0):
                for v in (t * wm, c * wm):
                    values |= {v, v // 4, v // 8, v * 0.25, v // 8 * 0.25}
    for v in sorted(values):
        for divisor in (2, 4):
            assert ce.make_divisible(v, divisor) == jce.make_divisible(
                v, divisor), (v, divisor)


def test_hard_sigmoid_matches_jax():
    x = np.concatenate([np.linspace(-5, 5, 101),
                        np.random.RandomState(0).randn(100) * 4]).astype(
        np.float32)
    np.testing.assert_allclose(
        ce.hard_sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(jce.hard_sigmoid(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_global_pools_match_jax():
    x = np.random.RandomState(3).randn(2, 3, 4, 5, 6).astype(np.float32)
    np.testing.assert_allclose(
        _from_port(pool.adaptive_avg_pool3d_1(_to_port(x))),
        np.asarray(jpool.adaptive_avg_pool3d_1(jnp.asarray(x))), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_allclose(
        pool.global_avg_pool(_to_port(x)).numpy(),
        np.asarray(jpool.global_avg_pool(jnp.asarray(x))), rtol=1e-6,
        atol=1e-7)


def _module_pair(port, jax_module, x, renames):
    """The port module ``port`` with the weights of ``jax_module``'s seeded
    init (the bridge's names, their prefixes renamed by ``renames``) and
    both outputs on ``x`` (B, T, H, W, C)."""
    variables = jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    sd = {}
    for name, t in jax_variables_to_state_dict(jax.tree_util.tree_map(
            np.asarray, dict(variables))).items():
        for old, new in renames.items():
            if name.startswith(old):
                name = new + name[len(old):]
        sd[name] = t
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = _from_port(port.eval()(_to_port(x)))
    return got, np.asarray(jax_module.apply(variables, jnp.asarray(x)))


def test_squeeze_excite_matches_jax():
    x = np.random.RandomState(1).randn(2, 2, 5, 5, 24).astype(np.float32)
    got, want = _module_pair(SqueezeExcite(24), jghost.SqueezeExcite(), x,
                             {"reduce.": "conv_reduce.",
                              "expand.": "conv_expand."})
    np.testing.assert_allclose(got, want, **TOL)


def test_ghost_module_cuts_to_oup():
    """An odd ``oup``: the primary and cheap halves concatenated to
    2·ceil(oup / 2) channels, cut to oup."""
    x = np.random.RandomState(2).randn(2, 2, 5, 5, 8).astype(np.float32)
    got, want = _module_pair(
        GhostModule(8, 7), jghost.GhostModule(7), x,
        {"primary.conv.": "primary_conv.0.", "primary.bn.": "primary_conv.1.",
         "cheap.conv.": "cheap_operation.0.",
         "cheap.bn.": "cheap_operation.1."})
    assert got.shape == (2, 2, 5, 5, 7)
    np.testing.assert_allclose(got, want, **TOL)


def _fusion_tokens(cfg, model, inputs):
    """Slow tokens of each CMDA fusion's attention on ``inputs``."""
    tokens = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: tokens.append(
        int(np.prod(inp[0].shape[2:]))))
        for name, m in model.named_modules()
        if name.endswith("attention_spatial_s2f")]
    with torch.no_grad():
        model.eval()(torch_inputs(inputs))
    for hook in hooks:
        hook.remove()
    return tokens


@pytest.mark.parametrize("family", sorted(EFFICIENT))
def test_family_matches_jax(family, monkeypatch):
    cfg, jcfg = efficient_cfg(family), efficient_cfg(family, jax_get_cfg)
    configure(jcfg)
    inputs = inputs_np(cfg)
    variables = calibrate_fusions(cfg, efficient_variables(cfg), inputs)
    jmodel = jax_build_model(jcfg)

    def forwards(v, x):
        train, stats = jmodel.apply(v, x, train=True,
                                    mutable=["batch_stats"])
        return jmodel.apply(v, x, train=False), train, stats

    jeval, jtrain, jstats = compiled(forwards, variables,
                                     [jnp.asarray(x) for x in inputs])

    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg),
                          strict=True)
    tokens = _fusion_tokens(cfg, model, inputs)
    calls = []
    forward = fa._forward
    monkeypatch.setattr(fa, "_forward", lambda *a, **k: (
        calls.append(a[0].shape), forward(*a, **k))[1])
    with torch.no_grad():
        got_eval = model.eval()(torch_inputs(inputs)).numpy()
        got_train = model.train()(torch_inputs(inputs)).numpy()
    streamed = sum(n > cfg.TPU.FLASH_MIN_TOKENS for n in tokens)
    assert streamed >= 2 and len(calls) == 2 * streamed, (tokens, calls)

    scale = max(1.0, float(np.abs(jeval).max()))
    np.testing.assert_allclose(got_eval, np.asarray(jeval), rtol=TOL["rtol"],
                               atol=TOL["atol"] * scale)
    if cfg.MODEL.MODEL_NAME == "SlowFastGhostNet":
        # ReLU, then the mean: non-negative scores, not probabilities
        assert (got_eval >= 0).all() and got_eval.sum(1).min() > 1.5
    else:
        np.testing.assert_allclose(got_eval.sum(1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got_train, np.asarray(jtrain), **TRAIN_TOL)
    got_stats = flat_leaves(state_dict_to_jax_variables(
        model.state_dict(), cfg)["batch_stats"])
    want_stats = flat_leaves(jax.tree_util.tree_map(
        np.asarray, dict(jstats["batch_stats"])))
    assert got_stats.keys() == want_stats.keys()
    for key, want in want_stats.items():
        np.testing.assert_allclose(got_stats[key], want, err_msg=key,
                                   **TRAIN_TOL)


def test_cli_trains_and_tests_an_efficient_yaml(tmp_path):
    """The port's CLI takes an efficient family with no branch of its own:
    configs/Synthetic/SHUFFLENETV2_TINY.yaml trains an epoch (val,
    a checkpoint) and runs the 30-view test from that checkpoint, which
    loads strictly into a fresh model."""
    from efficient_slowfast_tpu_torch.config import load_cfg
    from efficient_slowfast_tpu_torch.tools.run_net import main
    from efficient_slowfast_tpu_torch.utils.checkpoint import \
        get_last_checkpoint

    yaml = "configs/Synthetic/SHUFFLENETV2_TINY.yaml"
    out = main(["--device", "cpu", "--cfg", yaml,
                "OUTPUT_DIR", str(tmp_path)])
    meter = out["test"]
    assert meter.stats["_type"] == "test_final"
    assert np.allclose(meter.video_preds.sum(1), meter.num_clips)
    path = get_last_checkpoint(str(tmp_path))
    model = build_model(load_cfg(yaml), device="cpu")
    model.load_state_dict(torch.load(path, weights_only=True)["model_state"],
                          strict=True)
    trained = out["train"].model.state_dict()
    for key, value in model.state_dict().items():
        assert torch.equal(value, trained[key]), key
