"""The port's optimizer, losses and metrics against the JAX package's:
``construct_optimizer`` against optax over three steps on one parameter
tree (SGD, nesterov, Adam, the BN weight-decay split, bf16 moments), the BN
parameter set (by owning module) against JAX's ``bn_mask`` through the
weight bridge for every registered family, the losses on
the same logits and labels, and top-k with ties, f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.models import losses as jlosses
from efficient_slowfast_tpu.models.optimizer import bn_mask
from efficient_slowfast_tpu.models.optimizer import \
    construct_optimizer as jax_construct_optimizer
from efficient_slowfast_tpu.utils import metrics as jmetrics
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.models import losses
from efficient_slowfast_tpu_torch.models.optimizer import (bn_param_names,
                                                           construct_optimizer,
                                                           set_lr)
from efficient_slowfast_tpu_torch.ops.conv import Conv3d, Linear
from efficient_slowfast_tpu_torch.ops.norm import BatchNorm3d
from efficient_slowfast_tpu_torch.utils import metrics
from efficient_slowfast_tpu_torch.utils.weights import (
    _torch_name, efficient_prefix_table, jax_variables_to_state_dict,
    state_dict_to_jax_variables)
from torch_port_helpers import (EFFICIENT, NLN_R50, efficient_cfg,
                                flat_leaves, small_cfg)

OPTIMIZERS = {
    # (method, momentum, nesterov, weight decay, BN weight decay, moments)
    "sgd_momentum": ("sgd", 0.9, False, 1e-2, 0.0, "float32"),
    "sgd_nesterov": ("sgd", 0.9, True, 1e-2, 0.0, "float32"),
    "sgd_plain": ("sgd", 0.0, False, 1e-2, 0.0, "float32"),
    "sgd_bn_split": ("sgd", 0.9, True, 1e-2, 5e-2, "float32"),
    "sgd_bf16_moments": ("sgd", 0.9, True, 1e-2, 0.0, "bfloat16"),
    "adam": ("adam", 0.9, False, 1e-2, 0.0, "float32"),
    "adam_bn_split_bf16_moments": ("adam", 0.9, False, 1e-2, 5e-2,
                                   "bfloat16"),
}
LRS = (0.1, 0.05, 0.2)  # one per step, set as the train step sets them


class _Tiny(nn.Module):
    """A conv, its BN and a classifier, named as the port's layers are."""

    def __init__(self):
        super().__init__()
        self.conv = Conv3d(3, 4, (1, 3, 3))
        self.conv_bn = BatchNorm3d(4)
        self.head = Linear(4, 5)


def _cfg(get, method, momentum, nesterov, wd, bn_wd, moments):
    cfg = get()
    cfg.SOLVER.OPTIMIZING_METHOD = method
    cfg.SOLVER.MOMENTUM = momentum
    cfg.SOLVER.NESTEROV = nesterov
    cfg.SOLVER.WEIGHT_DECAY = wd
    cfg.BN.WEIGHT_DECAY = bn_wd
    cfg.SOLVER.BASE_LR = LRS[0]
    cfg.TPU.OPTIMIZER_STATE_DTYPE = moments
    return cfg


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_steps_match_optax(name):
    torch.manual_seed(0)
    model = _Tiny()
    with torch.no_grad():  # BN scale and bias away from 1 and 0
        model.conv_bn.weight.uniform_(0.5, 1.5)
        model.conv_bn.bias.uniform_(-0.5, 0.5)
    params = state_dict_to_jax_variables(model.state_dict())["params"]
    rs = np.random.RandomState(1)
    grads = [jax.tree_util.tree_map(
        lambda p: rs.randn(*p.shape).astype(np.float32), params)
        for _ in LRS]
    tx, state = jax_construct_optimizer(
        _cfg(jax_get_cfg, *OPTIMIZERS[name]), params)
    jparams = params
    for g, lr in zip(grads, LRS):
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        updates, state = tx.update(g, state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
    opt = construct_optimizer(_cfg(get_cfg, *OPTIMIZERS[name]), model)
    for g, lr in zip(grads, LRS):
        sd = jax_variables_to_state_dict({"params": g})
        for n, p in model.named_parameters():
            p.grad = sd[n].clone()
        set_lr(opt, lr)
        opt.step()
    method, momentum, *_, dtype = OPTIMIZERS[name]
    moments = {v.dtype for st in opt.state.values() for k, v in st.items()
               if k != "step"}
    stateless = method == "sgd" and not momentum
    assert moments == (set() if stateless else {getattr(torch, dtype)})
    got = flat_leaves(state_dict_to_jax_variables(model.state_dict())
                      ["params"])
    # three steps of up to lr each (Adam's are lr in size): the two differ
    # by f32 rounding, a few 1e-6 of that motion
    for key, want in flat_leaves(jparams).items():
        np.testing.assert_allclose(got[key], want, rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_parameter_groups_carry_the_two_decays():
    cfg = _cfg(get_cfg, *OPTIMIZERS["sgd_bn_split"])
    model = _Tiny()
    opt = construct_optimizer(cfg, model)
    bn = {id(p) for n, p in model.named_parameters() if "bn" in n}
    assert [(g["weight_decay"], {id(p) for p in g["params"]} <= bn)
            for g in opt.param_groups] == [(1e-2, False), (5e-2, True)]
    assert sum(len(g["params"]) for g in opt.param_groups) == 5


def _family_cfg(model):
    if model in EFFICIENT:
        return efficient_cfg(model)
    if model == "ResNet":
        return small_cfg(model="ResNet", nonlocal_loc=NLN_R50)
    return small_cfg(model=model)


@pytest.mark.parametrize("model", ["SlowFast", "SlowFastDualAttention",
                                   "ResNet"] + sorted(EFFICIENT))
def test_bn_names_are_jax_bn_mask_through_the_bridge(model):
    """The parameters that the port's optimizer gives BN.WEIGHT_DECAY (those
    of its BatchNorm modules) are the ones JAX's ``bn_mask`` selects, for
    every registered family (the efficient ones by name table)."""
    cfg = _family_cfg(model)
    torch_model = build_model(cfg, device="cpu")
    params = state_dict_to_jax_variables(torch_model.state_dict(),
                                         cfg)["params"]
    table = efficient_prefix_table(cfg)
    mask = jax.tree_util.tree_leaves_with_path(bn_mask(params, True))
    jax_bn = {_torch_name(tuple(str(k.key) for k in path), table)
              for path, is_bn in mask if is_bn}
    port_bn = bn_param_names(torch_model)
    assert port_bn == jax_bn
    assert len(port_bn) > 50
    opt = construct_optimizer(cfg, torch_model)
    names = {id(p): n for n, p in torch_model.named_parameters()}
    decay = {names[id(p)]: g["weight_decay"] for g in opt.param_groups
             for p in g["params"]}
    assert {n for n, wd in decay.items() if wd == cfg.BN.WEIGHT_DECAY} == \
        port_bn and len(decay) == len(names)


def test_name_rule_misses_the_efficient_bns():
    """The rule the port had (a "bn" in the torch name) misses the
    efficient families' BNs, which the reference names by Sequential
    index: it would decay them with SOLVER.WEIGHT_DECAY where JAX uses
    BN.WEIGHT_DECAY."""
    model = build_model(efficient_cfg("shufflenetv2"), device="cpu")
    name = "s2.pathway0_channel_224.features.0.banch2.1.weight"
    by_name = {n for n, _ in model.named_parameters() if "bn" in n}
    assert name in bn_param_names(model) and name not in by_name
    assert len(bn_param_names(model) - by_name) > 200


def test_refusals_as_in_jax():
    cfg = _cfg(get_cfg, *OPTIMIZERS["sgd_momentum"])
    cfg.SOLVER.DAMPENING = 0.5
    with pytest.raises(AssertionError, match="dampening"):
        construct_optimizer(cfg, _Tiny())
    cfg = _cfg(get_cfg, *OPTIMIZERS["sgd_momentum"])
    cfg.SOLVER.OPTIMIZING_METHOD = "lamb"
    with pytest.raises(NotImplementedError):
        construct_optimizer(cfg, _Tiny())


def _logits(b=6, c=7, seed=0):
    rs = np.random.RandomState(seed)
    return (3 * rs.randn(b, c)).astype(np.float32)


@pytest.mark.parametrize("kind", ["integer", "soft"])
def test_cross_entropy_matches_jax(kind):
    logits = _logits()
    rs = np.random.RandomState(2)
    if kind == "integer":
        labels = rs.randint(0, 7, 6)
    else:
        labels = rs.rand(6, 7).astype(np.float32)
        labels /= labels.sum(-1, keepdims=True)
    want = float(jlosses.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels)))
    got = losses.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    assert float(got) == pytest.approx(want, rel=1e-6)
    # bf16 logits are taken in f32
    assert losses.cross_entropy(torch.from_numpy(logits).bfloat16(),
                                torch.from_numpy(labels)).dtype == \
        torch.float32


def test_binary_losses_match_jax_with_the_clip():
    rs = np.random.RandomState(3)
    logits = _logits()
    labels = (rs.rand(6, 7) > 0.5).astype(np.float32)
    probs = 1 / (1 + np.exp(-logits))
    probs[0, :3] = [0.0, 1.0, 1e-9]  # clipped to [1e-7, 1 - 1e-7]
    jp, jl = jnp.asarray(probs), jnp.asarray(labels)
    tp, tl = torch.from_numpy(probs), torch.from_numpy(labels)
    assert float(losses.bce(tp, tl)) == pytest.approx(
        float(jlosses.bce(jp, jl)), rel=1e-6)
    np.testing.assert_allclose(losses.bce_elementwise(tp, tl).numpy(),
                               np.asarray(jlosses.bce_elementwise(jp, jl)),
                               rtol=1e-6, atol=1e-7)
    assert float(losses.bce_logit(torch.from_numpy(logits), tl)) == \
        pytest.approx(float(jlosses.bce_logit(jnp.asarray(logits), jl)),
                      rel=1e-6)


@pytest.mark.parametrize("name", ["cross_entropy", "bce", "bce_logit",
                                  "focal"])
def test_loss_lookups_refuse_as_in_jax(name):
    for get_port, get_jax in ((losses.get_loss_func, jlosses.get_loss_func),
                              (losses.get_elementwise_loss_func,
                               jlosses.get_elementwise_loss_func)):
        try:
            get_jax(name)
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                get_port(name)
        else:
            assert get_port(name).__name__ == get_jax(name).__name__


def test_topk_with_ties_takes_jax_order():
    # integer-valued scores: ties at every rank; the lower class index wins
    rs = np.random.RandomState(4)
    preds = rs.randint(0, 3, (64, 9)).astype(np.float32)
    labels = rs.randint(0, 9, 64)
    jp, jl = jnp.asarray(preds), jnp.asarray(labels)
    tp, tl = torch.from_numpy(preds), torch.from_numpy(labels)
    for k in ((1, 5), (1, 2, 3), (4,)):
        for got, want in zip(metrics.topks_correct_per_sample(tp, tl, k),
                             jmetrics.topks_correct_per_sample(jp, jl, k)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for port_fn, jax_fn in ((metrics.topk_errors, jmetrics.topk_errors),
                            (metrics.topk_accuracies,
                             jmetrics.topk_accuracies),
                            (metrics.topks_correct, jmetrics.topks_correct)):
        np.testing.assert_allclose(
            [float(x) for x in port_fn(tp, tl, (1, 5))],
            [float(x) for x in jax_fn(jp, jl, (1, 5))], rtol=1e-6)
