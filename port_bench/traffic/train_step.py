"""Closed-loop training: back-to-back steps of the training entry (the
train state and its step, built once) on a pool of distinct seeded batches
with seeded labels, at a fixed learning rate, each step's dropout drawn
from a generator seeded for it, at most two steps queued ahead of the
host. Reports the clips stepped in the window over its length.

Set-up drives the same state and step through its first ``checked_steps``
steps on distinct batches (the warm-up): the program's loss of each, the
first step's logits (the model's output, read by a hook on its head for
that step alone), its first gradient per leaf (the optimizer's momentum
after one step, less the weight decay, which SGD adds before the
momentum) and its parameters' change per leaf after them are what the
reference's steps are held to.
"""

from __future__ import annotations

import torch

from port_bench import compare, program, recipe
from port_bench.driver import Driver as Base
from port_bench.reference.model import (Net, cross_entropy, float32_products,
                                        is_bn, sgd_step, trainable)


def _get(d, key, default):
    for part in key.split("."):
        if part not in d:
            return default
        d = d[part]
    return d


class Driver(Base):
    traced_iterations = 5

    def prepare(self) -> None:
        cfg = self.config["cfg"]
        self.lr = float(self.mix["lr"])
        self.momentum = float(_get(cfg, "SOLVER.MOMENTUM", 0.9))
        self.nesterov = bool(_get(cfg, "SOLVER.NESTEROV", True))
        wd = float(_get(cfg, "SOLVER.WEIGHT_DECAY", 1e-4))
        bn_wd = float(_get(cfg, "BN.WEIGHT_DECAY", 0.0))
        self.leaves = trainable(self.spec)
        self.decay = {n: bn_wd if is_bn(self.spec, n) else wd
                      for n in self.leaves}
        self.reference_weights = self.weights()
        self.reset_peak()
        self.pool = self.inputs(int(self.mix["pool"]))
        self.labels = [torch.randint(0, self.arch.num_classes, (self.batch,),
                                     generator=self.generator(5, i),
                                     device=self.device)
                       for i in range(len(self.pool))]

    def setup(self) -> None:
        self.prepare()
        net = program.model(self.cfg, recipe.state_dict(
            self.spec, self.reference_weights), self.device)
        self.state, self.step_fn = program.train_step(self.cfg, net,
                                                      self.device)
        self.steps = 0
        self.measured = self._checked_steps(int(self.mix["checked_steps"]))
        self.sync()

    def _run_step(self):
        i = self.steps % len(self.pool)
        mets = self.step_fn(self.state, self.pool[i], self.labels[i], self.lr,
                            generator=self.generator(6, self.steps))
        self.steps += 1
        return mets

    def _checked_steps(self, n: int) -> dict:
        params = dict(self.state.model.named_parameters())
        w0 = self.reference_weights
        losses, grad, logits = [], None, []
        hook = self.state.model.head.register_forward_hook(
            lambda m, args, out: logits.append(out.detach().float().clone()))
        for k in range(n):
            losses.append(self._run_step()["loss"].detach().float())
            if k == 0:
                hook.remove()
                grad = torch.stack([self._first_gradient(params[n], w0[n],
                                                         self.decay[n])
                                    for n in self.leaves])
        with torch.no_grad():
            change = torch.stack([(params[n].detach().float() - w0[n]).norm()
                                  for n in self.leaves])
        return {"loss": torch.stack(losses).tolist(), "logits": logits[0].cpu(),
                "grad": dict(zip(self.leaves, grad.tolist())),
                "change": dict(zip(self.leaves, change.tolist()))}

    def _first_gradient(self, param, w0, decay):
        """The norm of the gradient the optimizer took in its first step:
        its momentum less the weight decay (NaN where it kept none)."""
        buf = self.state.optimizer.state.get(param, {}).get("momentum_buffer")
        if buf is None:
            return torch.full((), float("nan"), device=self.device)
        with torch.no_grad():
            return (buf.float() - decay * w0).norm()

    def step(self) -> int:
        self._run_step()
        self.bound_queue()
        return self.batch

    def results(self, window) -> dict:
        return {"train_clips_per_s": window.units / window.seconds}

    def release(self) -> None:
        self.free("state", "step_fn")

    def reference_steps(self, n: int, rnd=None, inputs=None) -> dict:
        """The reference's first ``n`` steps from the same weights, batches,
        labels, dropout generators and learning rate: losses, first
        gradient norms and change norms per leaf. ``inputs(k)`` may give
        step k's (clips, labels) in place of the pool's."""
        w0 = self.reference_weights
        params = {n: w0[n].clone().requires_grad_() for n in self.leaves}
        fixed = {n: t for n, t in w0.items() if n not in params}
        bufs, losses, grad = {}, [], None
        kw = {} if rnd is None else {"rnd": rnd}
        with float32_products():
            for k in range(n):
                x, y = (self.pool[k], self.labels[k]) if inputs is None \
                    else inputs(k)
                net = Net(self.arch, {**fixed, **params}, train=True,
                          dropout_gen=self.generator(6, k), **kw)
                out = net(x)
                if k == 0:
                    logits = out.detach().cpu()
                loss = cross_entropy(out, y)
                grads = dict(zip(self.leaves, torch.autograd.grad(
                    loss, [params[n] for n in self.leaves])))
                losses.append(float(loss.detach()))
                if k == 0:
                    grad = {n: float(g.norm()) for n, g in grads.items()}
                sgd_step(params, bufs, grads, self.lr, self.momentum,
                         self.nesterov, self.decay)
                del net, out, loss, grads
        with torch.no_grad():
            change = {n: float((params[n] - w0[n]).norm()) for n in self.leaves}
        return {"loss": losses, "logits": logits, "grad": grad,
                "change": change}

    def compare(self, got: dict, ref: dict) -> list:
        self.compared = (got, ref)
        leaves = compare.kept_leaves(ref["grad"])
        return self.checks(
            logit_gap=compare.centred_gap(got["logits"], ref["logits"]),
            grad_median_gap=compare.median_gap(got["grad"], ref["grad"],
                                               leaves),
            update_median_gap=compare.median_gap(got["change"], ref["change"],
                                                 leaves))

    def check(self) -> list:
        ref = self.reference_steps(len(self.measured["loss"]))
        return self.compare(self.measured, ref)

    def control(self) -> list:
        """The control's numbers: the reference's steps computed in float8
        in the program's place."""
        n = int(self.mix["checked_steps"])
        return self.compare(self.reference_steps(n, compare.fp8),
                            self.reference_steps(n))

    def half_batch(self) -> list:
        """The numbers of a planted fault, in the reference put in the
        program's place: each step on half of its batch, the loss the mean
        over that half."""
        n, h = int(self.mix["checked_steps"]), self.batch // 2
        return self.compare(self.reference_steps(
            n, inputs=lambda k: ([x[:h] for x in self.pool[k]],
                                 self.labels[k][:h])),
            self.reference_steps(n))
