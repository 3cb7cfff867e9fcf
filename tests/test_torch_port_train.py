"""The port's train and eval steps against the JAX package's on the same
weights (carried across by the weight bridge) and inputs, f32 on the CPU:
SlowFast-R50 and CMDA-R50 at width 16, trained as the reference configs
train (final BN of each block zero-initialised, SGD with nesterov momentum
0.9, weight decay 1e-4 and none on BN), rtol = atol = 1e-4.

Learning rates. Three composed steps are held in full at lr 0.01, the rate
at which the reference configs' first steps run (``SOLVER.WARMUP_START_LR``
of ``configs/Kinetics/SLOWFAST_8x8_R50.yaml``). At the base lr 0.1 the
second step's loss jumps to ~9 on two clips and the third step's update is
ill-conditioned: each package's f32 step lands 10-140× the tolerance away
from the same step in float64, so there the three losses and the state
after the first step are held, which is as far as float32 repeats itself.

Also here: gradient accumulation against JAX, stage remat as a no-op, the
BN running variance against flax, the eval step with a padding mask, and
the head's dropout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.engine.state import TrainState as JaxTrainState
from efficient_slowfast_tpu.engine.state import \
    make_eval_step as jax_make_eval_step
from efficient_slowfast_tpu.models import build_model as jax_build_model
from efficient_slowfast_tpu.ops.norm import BatchNorm3d as JaxBatchNorm3d
from efficient_slowfast_tpu.ops.options import configure
from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                       make_eval_step,
                                                       make_train_step,
                                                       pathway_inputs)
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.models.heads import dropout
from efficient_slowfast_tpu_torch.ops.kernels import flash_attention as fa
from efficient_slowfast_tpu_torch.ops.norm import BatchNorm3d
from efficient_slowfast_tpu_torch.utils.weights import (
    jax_variables_to_state_dict, state_dict_to_jax_variables)
from torch_port_helpers import (calibrate_attention, flat_leaves,
                                jax_train_runs, jax_train_variables,
                                port_train_run, torch_inputs, train_batches,
                                train_cfg)

TOL = dict(rtol=1e-4, atol=1e-4)
CMDA = "SlowFastDualAttention"
# CMDA's s1/s2 fusions attend over 512 tokens: above 256 they take the
# streaming path, flash_attention's autograd Function (its plain versions
# on the CPU), as JAX takes its custom_vjp. Its query and key convs are
# scaled so that the logits have std 3 (calibrate_attention): at init they
# reach std 40-90, where the softmax's gradient cancels to rounding noise
# and JAX's compiled step and its own eager ops already disagree.
MODELS = {"slowfast": dict(model="SlowFast"),
          "cmda": dict(model=CMDA, flash_min_tokens=256)}
WARMUP_LR, BASE_LR = 0.01, 0.1


@pytest.fixture(autouse=True)
def _restore_jax_options():
    yield
    configure(jax_get_cfg())  # JAX keeps its kernel options process-wide


@pytest.fixture(scope="module", params=sorted(MODELS))
def trajectories(request):
    """JAX's two runs of three steps (lr 0.01, lr 0.1) from one init."""
    kw = MODELS[request.param]
    batches = train_batches(train_cfg(**kw), steps=3)
    runs = [[(x, y, lr) for x, y in batches] for lr in (WARMUP_LR, BASE_LR)]
    variables = jax_train_variables(batches[0][0], **kw)
    if kw["model"] == CMDA:
        variables = calibrate_attention(variables, batches[0][0], **kw)
    out = jax_train_runs(variables, runs, **kw)
    configure(jax_get_cfg())
    return kw, variables, runs, out


def _assert_variables_close(port, ref):
    fp, fr = flat_leaves(port), flat_leaves(ref)
    assert set(fp) == set(fr)
    for key in sorted(fr):
        np.testing.assert_allclose(fp[key], fr[key], err_msg=key, **TOL)


def test_three_steps_match_jax(trajectories, monkeypatch):
    kw, variables, runs, jax_out = trajectories
    calls = []
    bwd = fa.flash_attention_backward
    monkeypatch.setattr(fa, "flash_attention_backward",
                        lambda *a: calls.append(1) or bwd(*a))
    losses, snaps, mets, state = port_train_run(variables, runs[0], **kw)
    jax_losses, jax_snaps, jax_mets = jax_out[0]
    np.testing.assert_allclose(losses, jax_losses, **TOL)
    _assert_variables_close(snaps[-1], jax_snaps[-1])
    assert state.step == 3
    assert set(mets) == set(jax_mets) == {"loss", "lr", "top1_err",
                                          "top5_err"}
    for key in mets:
        assert mets[key] == pytest.approx(jax_mets[key], rel=1e-4), key
    if kw["model"] == CMDA:
        # two streaming fusions a step, each through the Function's backward
        assert len(calls) == 6


@pytest.mark.parametrize("trajectories", ["cmda"], indirect=True)
def test_cmda_opt_out_matches_jax(trajectories, monkeypatch):
    # TPU.FLASH_ATTENTION False: plain_attention, the plain versions as the
    # same autograd Function, against the same JAX trajectory
    kw, variables, runs, jax_out = trajectories
    calls = []
    monkeypatch.setattr(fa, "flash_attention_backward",
                        lambda *a: calls.append(1))
    losses, snaps, _, _ = port_train_run(variables, runs[0], flash=False,
                                         **kw)
    np.testing.assert_allclose(losses, jax_out[0][0], **TOL)
    _assert_variables_close(snaps[-1], jax_out[0][1][-1])
    assert not calls


def test_base_lr_matches_jax_as_far_as_float32_repeats(trajectories):
    kw, variables, runs, jax_out = trajectories
    losses, snaps, _, _ = port_train_run(variables, runs[1], **kw)
    jax_losses, jax_snaps, _ = jax_out[1]
    np.testing.assert_allclose(losses, jax_losses, **TOL)
    _assert_variables_close(snaps[0], jax_snaps[0])
    if kw["model"] == CMDA:
        # the attention's gradient moves its convs by four times the
        # tolerance or more, so a port without it would not match
        init, step1 = flat_leaves(variables), flat_leaves(jax_snaps[0])
        for fuse in ("s1_fuse", "s2_fuse"):
            for conv in ("query", "key", "value"):
                key = f"params/{fuse}/attention_spatial_s2f/{conv}/conv/kernel"
                moved = np.abs(step1[key] - init[key]).max()
                tol = TOL["atol"] + TOL["rtol"] * np.abs(init[key]).max()
                assert moved > 4 * tol, (key, moved, tol)


def test_grad_accumulation_matches_jax():
    kw = dict(model="SlowFast", accum=2)
    batches = train_batches(train_cfg(**kw), steps=2, batch=4)
    run = [(x, y, WARMUP_LR) for x, y in batches]
    variables = jax_train_variables(batches[0][0], **kw)
    (jax_losses, jax_snaps, jax_mets), = jax_train_runs(variables, [run],
                                                        **kw)
    losses, snaps, mets, _ = port_train_run(variables, run, **kw)
    np.testing.assert_allclose(losses, jax_losses, **TOL)
    _assert_variables_close(snaps[-1], jax_snaps[-1])
    for key in mets:
        assert mets[key] == pytest.approx(jax_mets[key], rel=1e-4), key


def _torch_variables(**kw):
    torch.manual_seed(0)
    return state_dict_to_jax_variables(
        build_model(train_cfg(**kw), device="cpu").state_dict())


@pytest.mark.parametrize("model", sorted(MODELS))
def test_remat_stage_is_a_noop(model):
    # the counterpart of
    # tests/test_train.py::test_remat_stages_is_semantic_noop
    kw = MODELS[model]
    variables = _torch_variables(**kw)
    run = [(x, y, WARMUP_LR)
           for x, y in train_batches(train_cfg(**kw), steps=2)]
    base = port_train_run(variables, run, **kw)
    remat = port_train_run(variables, run, remat=True, remat_stages=[2], **kw)
    assert remat[3].model.s2.remat and not remat[3].model.s3.remat
    assert not base[3].model.s2.remat
    assert remat[0] == base[0]
    for a, b in zip(flat_leaves(remat[1][-1]).items(),
                    flat_leaves(base[1][-1]).items()):
        np.testing.assert_array_equal(a[1], b[1], err_msg=a[0])
    # running statistics were updated once per step, not again in the
    # recompute
    for m in remat[3].model.modules():
        if isinstance(m, BatchNorm3d):
            assert int(m.num_batches_tracked) == 2


def test_remat_recomputes_the_named_stage_only():
    cfg = train_cfg(remat=True, remat_stages=[2])
    model = build_model(cfg, device="cpu")
    state = create_train_state(cfg, model, device="cpu")
    step = make_train_step(cfg, model, state.optimizer)
    seen = {"s2": 0, "s3": 0}
    for stage in seen:
        bn = getattr(model, stage).pathway0_res0.branch2.a_bn
        bn.register_forward_hook(
            lambda *a, stage=stage: seen.__setitem__(stage, seen[stage] + 1))
    (x, y), = train_batches(cfg, steps=1)
    step(state, torch_inputs(x), torch.from_numpy(y), WARMUP_LR)
    assert seen == {"s2": 2, "s3": 1}  # s2's forward ran again in backward


def test_bn_running_variance_matches_flax_at_reduce_size_8():
    rs = np.random.RandomState(5)
    x = (2.0 * rs.randn(2, 2, 1, 2, 3) + 1.0).astype(np.float32)  # 8 a channel
    jmod = JaxBatchNorm3d(momentum=0.1)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    stats = {"mean": np.float32([0.1, -0.2, 0.3]),
             "var": np.float32([1.5, 0.5, 2.0])}
    variables = {"params": {"bn": {"scale": np.float32([1.0, 0.5, 2.0]),
                                   "bias": np.float32([0.0, 0.1, -0.1])}},
                 "batch_stats": {"bn": stats}}
    y, upd = jmod.apply(variables, jnp.asarray(x), train=True,
                        mutable=["batch_stats"])
    port = BatchNorm3d(3)
    bn = variables["params"]["bn"]
    port.load_state_dict({"weight": torch.from_numpy(bn["scale"]),
                          "bias": torch.from_numpy(bn["bias"]),
                          "running_mean": torch.from_numpy(stats["mean"]),
                          "running_var": torch.from_numpy(stats["var"]),
                          "num_batches_tracked": torch.tensor(0)})
    native = torch.nn.BatchNorm3d(3)
    native.load_state_dict(port.state_dict())
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        out = port.train()(xt)
        native.train()(xt)
    np.testing.assert_allclose(out.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["bn"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["bn"]["var"]),
                               rtol=1e-6, atol=1e-7)
    # torch's own update takes the unbiased variance, 8/7 of flax's
    batch_var = (native.running_var - 0.9 * torch.from_numpy(stats["var"]))
    np.testing.assert_allclose(
        (port.running_var - 0.9 * torch.from_numpy(stats["var"])).numpy(),
        (batch_var * 7 / 8).numpy(), rtol=1e-5)


def test_eval_step_matches_jax_with_a_padding_mask():
    cfg = train_cfg()
    batch, = train_batches(cfg, steps=1, batch=4)
    inputs, _ = batch
    variables = jax_train_variables(inputs)
    jcfg = train_cfg(jax_get_cfg)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=None)
    jstep = jax_make_eval_step(jcfg, jax_build_model(jcfg))
    jx = [jnp.asarray(x) for x in inputs]
    preds = np.asarray(jstep(jstate, jx, jnp.zeros(4, jnp.int32))["preds"])
    # right, masked out, wrong and second best
    order = np.argsort(-preds, axis=-1, kind="stable")
    labels = np.int32([order[0, 0], order[1, 0], order[2, 7], order[3, 1]])
    valid = np.float32([1, 0, 1, 1])
    ref = jstep(jstate, jx, jnp.asarray(labels), jnp.asarray(valid))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    state = create_train_state(cfg, model, device="cpu")
    out = make_eval_step(cfg, model)(state, torch_inputs(inputs),
                                     torch.from_numpy(labels),
                                     torch.from_numpy(valid))
    np.testing.assert_allclose(out["preds"].numpy(), np.asarray(ref["preds"]),
                               **TOL)
    assert set(out) == {"preds", "top1_err", "top5_err", "num_valid"}
    assert float(out["num_valid"]) == float(ref["num_valid"]) == 3.0
    for key in ("top1_err", "top5_err"):
        assert float(out[key]) == pytest.approx(float(ref[key]), abs=1e-4)
    assert float(out["top1_err"]) == pytest.approx(200.0 / 3)
    assert float(out["top5_err"]) == pytest.approx(100.0 / 3)


def _dropout_step(seed, rate=0.5):
    cfg = train_cfg()
    cfg.MODEL.DROPOUT_RATE = rate
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    state = create_train_state(cfg, model, device="cpu")
    (x, y), = train_batches(cfg, steps=1)
    mets = make_train_step(cfg, model, state.optimizer)(
        state, torch_inputs(x), torch.from_numpy(y), WARMUP_LR,
        torch.Generator().manual_seed(seed))
    return float(mets["loss"]), model.head.projection.weight.detach().clone()


def test_dropout_same_generator_seed_same_step():
    loss_a, w_a = _dropout_step(0)
    loss_b, w_b = _dropout_step(0)
    loss_c, w_c = _dropout_step(1)
    assert loss_a == loss_b and torch.equal(w_a, w_b)
    assert loss_a != loss_c and not torch.equal(w_a, w_c)


@pytest.mark.parametrize("rate", [0.5, 0.25])
def test_dropout_keeps_one_minus_rate_scaled_up(rate):
    gen = torch.Generator().manual_seed(3)
    out = dropout(torch.ones(200000), rate, gen)
    kept = out != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 5e-3
    assert torch.all(out[kept] == 1 / (1 - rate))


def test_dropout_in_train_mode_only_and_the_step_needs_a_generator():
    cfg = train_cfg()
    cfg.MODEL.DROPOUT_RATE = 0.5
    model = build_model(cfg, device="cpu")
    x = [t.uniform_(generator=torch.Generator().manual_seed(2))
         for t in pathway_inputs(cfg, 2, device="cpu")]
    with torch.no_grad():
        a = model.eval()(x)
        torch.testing.assert_close(model(x), a, rtol=0, atol=0)
        model.train()
        b = model(x, generator=torch.Generator().manual_seed(0))
        torch.testing.assert_close(
            model(x, generator=torch.Generator().manual_seed(0)), b, rtol=0,
            atol=0)
        assert not torch.equal(
            b, model(x, generator=torch.Generator().manual_seed(1)))
    state = create_train_state(cfg, model, device="cpu")
    (x, y), = train_batches(cfg, steps=1)
    with pytest.raises(ValueError, match="Generator"):
        make_train_step(cfg, model, state.optimizer)(
            state, torch_inputs(x), torch.from_numpy(y), WARMUP_LR)
