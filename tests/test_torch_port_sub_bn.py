"""The port's split-batch BN and precise BN against the JAX package's, f32
on the CPU, on the same seeded numpy inputs and statistics:

- ``SubBatchNorm3d`` at 2 and 4 splits: two train-mode steps (outputs and
  all four statistics), then eval after both aggregate, at 1e-5;
- the state-dict conversions (plain ↔ split, two split counts, the
  adaptation to a target's form) and ``aggregate_sub_bn_stats`` on a CMDA
  model's statistics, against JAX's pytree walks at 1e-5;
- ``calculate_and_update_precise_bn`` over 2 batches of the synthetic
  loader, with the deterministic preprocess of
  tests/test_torch_port_train_loop.py: on a split BN and a plain BN at
  1e-5, and on a split-BN SlowFast-R50 at width 16.
"""

import importlib

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.data.loader import \
    construct_loader as jax_construct_loader
from efficient_slowfast_tpu.data.preprocess import \
    make_train_preprocess as jax_make_train_preprocess
from efficient_slowfast_tpu.engine.state import TrainState as JaxTrainState
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu.ops import norm as jax_norm
from efficient_slowfast_tpu.ops.options import configure
from efficient_slowfast_tpu.parallel.mesh import build_mesh
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.data.loader import construct_loader
from efficient_slowfast_tpu_torch.data.preprocess import make_train_preprocess
from efficient_slowfast_tpu_torch.engine.precise_bn import \
    calculate_and_update_precise_bn
from efficient_slowfast_tpu_torch.engine.state import create_train_state
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.ops import norm
from efficient_slowfast_tpu_torch.utils.weights import (
    jax_variables_to_state_dict, state_dict_to_jax_variables)
from torch_port_helpers import flat_leaves, seeded_variables, small_cfg

jax_precise = importlib.import_module(
    "efficient_slowfast_tpu.engine.precise_bn")
TOL = dict(rtol=1e-5, atol=1e-5)
C = 6


@pytest.fixture(autouse=True)
def _restore_jax_options():
    yield
    configure(jax_get_cfg())  # JAX keeps its kernel options process-wide


def _stats(rs, splits):
    return {"split_mean": rs.randn(splits, C).astype(np.float32),
            "split_var": rs.uniform(0.5, 2, (splits, C)).astype(np.float32),
            "mean": rs.randn(C).astype(np.float32),
            "var": rs.uniform(0.5, 2, C).astype(np.float32)}


def _port_stats(m):
    return {"split_mean": m.split_bn.running_mean.view(-1, C).numpy(),
            "split_var": m.split_bn.running_var.view(-1, C).numpy(),
            "mean": m.bn.running_mean.numpy(), "var": m.bn.running_var.numpy()}


@pytest.mark.parametrize("splits", [2, 4])
def test_sub_batchnorm_matches_jax(splits):
    rs = np.random.RandomState(splits)
    stats = _stats(rs, splits)
    scale = rs.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rs.randn(C).astype(np.float32)
    xs = [(rs.randn(8, 2, 3, 4, C) * 2 + 1).astype(np.float32)
          for _ in range(2)]

    jmod = jax_norm.SubBatchNorm3d(num_splits=splits)
    jvars = {"params": {"bn": {"scale": scale, "bias": bias}},
             "batch_stats": {"bn": stats}}
    apply = jax.jit(lambda v, x: jmod.apply(v, x, train=True,
                                            mutable=["batch_stats"]))
    mod = norm.SubBatchNorm3d(C, num_splits=splits)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        mod.split_bn.running_mean.copy_(torch.from_numpy(
            stats["split_mean"].reshape(-1)))
        mod.split_bn.running_var.copy_(torch.from_numpy(
            stats["split_var"].reshape(-1)))
        mod.bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        mod.bn.running_var.copy_(torch.from_numpy(stats["var"]))
    to_port = lambda x: torch.from_numpy(x).permute(0, 4, 1, 2, 3)  # noqa
    mod.train()
    for x in xs:  # two train-mode steps
        y, upd = apply(jvars, jnp.asarray(x))
        jvars = {"params": jvars["params"], "batch_stats": upd["batch_stats"]}
        with torch.no_grad():
            got = mod(to_port(x)).permute(0, 2, 3, 4, 1).numpy()
        np.testing.assert_allclose(got, np.asarray(y), **TOL)
        for k, v in _port_stats(mod).items():
            np.testing.assert_allclose(v, np.asarray(
                jvars["batch_stats"]["bn"][k]), err_msg=k, **TOL)
    assert int(mod.split_bn.num_batches_tracked) == 2

    agg = jax_norm.aggregate_sub_bn_stats(jvars["batch_stats"])
    assert norm.aggregate_sub_bn_stats(mod) == 1
    jvars = {"params": jvars["params"], "batch_stats": agg}
    y = jmod.apply(jvars, jnp.asarray(xs[0]), train=False)
    mod.eval()
    with torch.no_grad():
        got = mod(to_port(xs[0])).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(y), **TOL)
    with pytest.raises(ValueError, match="not divisible"):
        mod.train()(to_port(xs[0])[:splits + 1])


def _cmda_stats(norm_type="batchnorm", splits=1):
    """Seeded CMDA-R50 (width 16) state dict with its statistics drawn, in
    the form of ``norm_type``."""
    cfg = small_cfg(model="SlowFastDualAttention")
    cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS = norm_type, splits
    torch.manual_seed(0)
    sd = build_model(cfg, device="cpu").state_dict()
    rs = np.random.RandomState(splits)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(torch.from_numpy(rs.randn(*v.shape).astype(np.float32)))
        elif k.endswith("running_var"):
            v.copy_(torch.from_numpy(
                rs.uniform(0.5, 2, v.shape).astype(np.float32)))
    return cfg, sd


def _jax_stats(sd):
    return state_dict_to_jax_variables(sd)["batch_stats"]


def _assert_stats_equal(sd, jax_tree):
    got, ref = flat_leaves(_jax_stats(sd)), flat_leaves(
        jax.tree_util.tree_map(np.asarray, jax_tree))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **TOL)


def test_bn_conversions_and_aggregation_match_jax():
    _, plain = _cmda_stats()
    cfg2, sub2 = _cmda_stats("sub_batchnorm", 2)
    cfg4, sub4 = _cmda_stats("sub_batchnorm", 4)
    # plain → split, split → plain, split → another split count
    _assert_stats_equal(
        norm.convert_bn_stats(plain, "batchnorm", "sub_batchnorm", 2),
        jax_norm.convert_bn_stats(_jax_stats(plain), "batchnorm",
                                  "sub_batchnorm", 2))
    _assert_stats_equal(
        norm.convert_bn_stats(sub2, "sub_batchnorm", "batchnorm", 1),
        jax_norm.convert_bn_stats(_jax_stats(sub2), "sub_batchnorm",
                                  "batchnorm", 1))
    _assert_stats_equal(
        norm.convert_bn_stats(sub2, "sub_batchnorm", "sub_batchnorm", 4),
        jax_norm.convert_bn_stats(_jax_stats(sub2), "sub_batchnorm",
                                  "sub_batchnorm", 4))
    # a payload adapted to a target's form: split count from the target
    for target, src in ((sub4, sub2), (sub4, plain), (plain, sub2)):
        _assert_stats_equal(
            norm.adapt_bn_stats_to(target, src),
            jax_norm.adapt_bn_stats_to(_jax_stats(target), _jax_stats(src)))
    # each result loads into the model of its form with strict=True
    torch.manual_seed(0)
    model = build_model(cfg4, device="cpu")
    model.load_state_dict(norm.normal_to_sub_bn(plain, 4), strict=True)
    model.load_state_dict(norm.adapt_bn_stats_to(sub4, sub2), strict=True)
    # aggregation in place on the model, against JAX's walk
    model.load_state_dict(sub4, strict=True)
    assert norm.aggregate_sub_bn_stats(model) == len(
        [k for k in sub4 if k.endswith("split_bn.running_mean")])
    _assert_stats_equal(model.state_dict(),
                        jax_norm.aggregate_sub_bn_stats(_jax_stats(sub4)))


def precise_cfg(get, s=32):
    cfg = small_cfg(get)
    cfg.DATA.CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = cfg.DATA.TRAIN_CROP_SIZE = s
    cfg.DATA.TRAIN_JITTER_SCALES = [s, s]
    cfg.DATA.RANDOM_FLIP = False
    cfg.MODEL.DROPOUT_RATE = 0.0
    cfg.TRAIN.DATASET = "synthetic"
    cfg.TRAIN.BATCH_SIZE = 4
    cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS = "sub_batchnorm", 2
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.TPU.DATA_AXIS = 1
    return cfg


def _train_loader(cfg, construct, clips=8):
    ld = construct(cfg, "train")
    ds = ld.dataset
    for name in ("_path_to_videos", "_labels", "_spatial_temporal_idx"):
        setattr(ds, name, getattr(ds, name)[:clips])
    return ld


class _JaxPathwayBNs(flax.linen.Module):
    """A split BN on the slow pathway's pixels and a plain one on the
    fast pathway's."""

    @flax.linen.compact
    def __call__(self, x, train=False):
        return [jax_norm.SubBatchNorm3d(num_splits=2, name="slow")(x[0], train),
                jax_norm.BatchNorm3d(name="fast")(x[1], train)]


class _PathwayBNs(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.slow = norm.SubBatchNorm3d(3, num_splits=2)
        self.fast = norm.BatchNorm3d(3)

    def forward(self, x, generator=None):
        # contiguous NCDHW: torch's CPU batch norm sums a channels-last
        # tensor's variance less exactly (measured 2.7e-6 of it, against
        # 7e-8 here, over 32768 values a channel)
        return [self.slow(x[0].permute(0, 4, 1, 2, 3).contiguous()),
                self.fast(x[1].permute(0, 4, 1, 2, 3).contiguous())]


def _precise_runs(variables, jax_model, port_model, s):
    """JAX's and the port's precise BN from ``variables`` over 2 batches
    of 4 clips: (JAX's statistics, the port's, the port's model)."""
    cfg = precise_cfg(jax_get_cfg, s)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=None)
    pre = jax_make_train_preprocess(cfg)
    fixed = lambda k, f, w, p, u: pre(k, f, w, p,  # noqa: E731
                                      jnp.full(u.shape, 0.5, jnp.float32))
    state = jax_precise.calculate_and_update_precise_bn(
        cfg, state, jax_model, _train_loader(cfg, jax_construct_loader), fixed,
        build_mesh(cfg), jax.random.PRNGKey(0), num_batches=2)
    ref = jax.tree_util.tree_map(np.asarray, state.batch_stats)

    cfg = precise_cfg(get_cfg, s)
    port_model.load_state_dict(jax_variables_to_state_dict(variables),
                               strict=True)
    tstate = create_train_state(cfg, port_model, device="cpu")
    params = {k: v.clone() for k, v in port_model.named_parameters()}
    counts = {k: v.clone() for k, v in port_model.state_dict().items()
              if k.endswith("num_batches_tracked")}
    pre = make_train_preprocess(cfg)
    fixed = lambda g, f, w, p, u: pre(g, f, w, p,  # noqa: E731
                                      torch.full(u.shape, 0.5))
    calculate_and_update_precise_bn(cfg, tstate,
                                    _train_loader(cfg, construct_loader),
                                    fixed, num_batches=2)
    for k, v in port_model.named_parameters():
        assert torch.equal(v, params[k]), k
    for k, v in counts.items():
        assert torch.equal(port_model.state_dict()[k], v), k
    init = jax_variables_to_state_dict(variables)
    moved = max((v - init[k]).abs().max().item()
                for k, v in port_model.state_dict().items()
                if k.endswith("running_var"))
    assert moved > 1e-2  # the statistics are the batches', not the init's
    return ref, port_model.state_dict()


def test_precise_bn_matches_jax():
    """The mechanism at 1e-5: a split BN and a plain BN straight on the
    two pathways' pixels, the loader's 2 batches through the preprocess,
    the momentum inversion and the mean."""
    port = _PathwayBNs()
    rs = np.random.RandomState(3)
    sd = {k: torch.from_numpy(rs.uniform(0.5, 1.5, v.shape).astype(
        np.float32)) if v.is_floating_point() else v
        for k, v in port.state_dict().items()}
    variables = state_dict_to_jax_variables(sd)
    ref, got = _precise_runs(variables, _JaxPathwayBNs(), port, 32)
    _assert_stats_equal(got, ref)


def test_precise_bn_of_slowfast_r50_matches_jax():
    """SlowFast-R50 at width 16 with split BN, 64² crops. Through s3's
    fusion every statistic is held at 1e-5. Deeper, each BN's split sees
    few values (s5: 16 a channel) and float32 does not repeat itself: the
    port's statistics in float32 differ from the same run in float64 by up
    to 7e-5 of themselves at s5, the JAX package's from it by up to 9e-4
    (at 32²), and the inversion divides each batch statistic's rounding
    by m = 0.1. There the two are held within 1e-3 of each statistic's
    scale (max |statistic|)."""
    cfg = precise_cfg(get_cfg, 64)
    variables = seeded_variables(cfg)
    ref, got = _precise_runs(variables,
                             jax_build_model(precise_cfg(jax_get_cfg, 64)),
                             build_model(cfg, device="cpu"), 64)
    fg = flat_leaves(_jax_stats(got))
    fr = flat_leaves(ref)
    assert set(fg) == set(fr)
    for k in fr:
        if k.split("/")[0] in ("s4", "s4_fuse", "s5"):
            scale = max(float(np.abs(fr[k]).max()), 1.0)
            np.testing.assert_allclose(fg[k], fr[k], rtol=0, atol=1e-3 * scale,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(fg[k], fr[k], err_msg=k, **TOL)
