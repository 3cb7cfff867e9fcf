"""The plain reference against the port's plain path on the CPU, at a tiny
size in float32: the same weights and inputs through both."""

import dataclasses

import pytest
import torch

from port_bench import compare, program, recipe, window
from port_bench.reference.model import Net, cross_entropy, trainable
from port_bench.tests import tiny


@pytest.mark.parametrize("config,fused", [("slowfast_r50_8x8", True),
                                          ("slowfast_r50_8x8", False),
                                          ("cmda_r50_8x8", False)])
def test_eval_scores_match_the_port(config, fused):
    d = tiny.driver(config, "test64")
    d.config["overrides"]["TPU.FUSED_EVAL"] = fused
    d.cfg = program.port_cfg(d.config)
    d.setup()
    x = d.pool[0]
    got = d.forward(x)
    want = Net(d.arch, d.reference_weights)(x)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-7)
    assert compare.score_gap(got, want) < 1e-3


@pytest.mark.parametrize("config", ["slowfast_r50_8x8", "cmda_r50_8x8"])
def test_train_forward_and_gradients_match_the_port(config):
    d = tiny.driver(config, "train16")
    d.prepare()
    w, x, y = d.reference_weights, d.pool[0], d.labels[0]
    net = program.model(d.cfg, recipe.state_dict(d.spec, w), "cpu").train()
    loss = cross_entropy(net(x, generator=d.generator(6, 0)), y)
    loss.backward()
    params = {n: w[n].clone().requires_grad_() for n in trainable(d.spec)}
    ref = cross_entropy(Net(d.arch, {**w, **params}, train=True,
                            dropout_gen=d.generator(6, 0))(x), y)
    grads = torch.autograd.grad(ref, list(params.values()))
    assert abs(loss.item() - ref.item()) < 1e-5 * abs(ref.item())
    got = dict(net.named_parameters())
    norms = {n: float(g.norm()) for n, g in zip(params, grads)}
    leaves = compare.kept_leaves(norms)
    prog = {n: float(got[n].grad.norm()) for n in params}
    # float32 on both sides: the gap is round-off, amplified by the small
    # batch's BN statistics
    assert max(compare.leaf_gaps(prog, norms, leaves).values()) < 0.1


def test_first_step_through_the_driver():
    d = tiny.driver("cmda_r50_8x8", "train16", checked_steps=1,
                    limits={"logit_gap": 1e-3, "grad_median_gap": 1e-3,
                            "update_median_gap": 1e-3})
    d.setup()
    window.run(d, 0.1)
    d.release()
    for name, value, limit in d.check():
        assert value <= limit, name


def test_dense_and_blocked_attention_agree():
    from port_bench.reference.attention import blocked, dense

    q, k = torch.randn(2, 50, 4) * 2, torch.randn(2, 40, 4) * 2
    v, do = torch.randn(2, 40, 3), torch.randn(2, 50, 3)
    grads = []
    for f in (blocked, dense):
        t = [a.clone().requires_grad_() for a in (q, k, v)]
        out = f(*t)
        grads.append([out] + list(torch.autograd.grad(out, t, do)))
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-5)


def test_arch_refuses_what_it_does_not_implement():
    from port_bench.reference.model import arch_from

    cfg = tiny.config("slowfast_r50_8x8")["cfg"]
    cfg["NONLOCAL"]["LOCATION"] = [[[1], []], [[], []], [[], []], [[], []]]
    with pytest.raises(NotImplementedError):
        arch_from(cfg)
    assert dataclasses.is_dataclass(arch_from(tiny.config(
        "cmda_r50_8x8")["cfg"]))
