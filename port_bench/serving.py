"""What the serving kinds share: the program's forward, a pool of resident
inputs, and the check of a sample of the window's answers against the
reference's scores."""

from __future__ import annotations

from collections import defaultdict

import torch

from . import compare, program, recipe
from .driver import Driver
from .reference.model import Net, float32_products

# clips of a reference call
_REFERENCE_CLIPS = 8


class ServingDriver(Driver):
    def prepare(self) -> None:
        self.reference_weights = self.weights()
        self.reset_peak()
        self.pool = self.inputs(int(self.mix["pool"]))
        self.answers = []  # (pool index, scores (batch, classes))

    def setup(self) -> None:
        self.prepare()
        net = program.model(self.cfg, recipe.state_dict(
            self.spec, self.reference_weights), self.device)
        self.forward = program.forward(self.cfg, net, self.device)
        for x in self.pool[:2]:
            self.forward(x)
        self.sync()

    def release(self) -> None:
        self.free("forward")

    def sample(self):
        """A seeded sample of the answers: [(pool index, row, scores)]."""
        rows = len(self.answers) * self.batch
        n = min(int(self.mix["sample_clips"]), rows)
        picks = sorted(self.rng(4).choice(rows, size=n, replace=False))
        return [(self.answers[p // self.batch][0], p % self.batch,
                 self.answers[p // self.batch][1][p % self.batch].float().cpu())
                for p in picks]

    def scores(self, picks, rnd=None) -> torch.Tensor:
        """The reference's scores of the picked clips, in their order."""
        by_pool = defaultdict(list)
        for k, (i, row, _) in enumerate(picks):
            by_pool[i].append((k, row))
        out = [None] * len(picks)
        kw = {} if rnd is None else {"rnd": rnd}
        with torch.no_grad(), float32_products():
            for i, items in by_pool.items():
                for a in range(0, len(items), _REFERENCE_CLIPS):
                    part = items[a:a + _REFERENCE_CLIPS]
                    rows = torch.tensor([r for _, r in part],
                                        device=self.device)
                    x = [t.index_select(0, rows) for t in self.pool[i]]
                    got = Net(self.arch, self.reference_weights, **kw)(x)
                    for (k, _), s in zip(part, got.cpu()):
                        out[k] = s
        return torch.stack(out)

    def control(self) -> list:
        """The control's numbers: the reference computed in float8 in the
        program's place, on a seeded sample of the pool's clips."""
        rows = len(self.pool) * self.batch
        n = min(int(self.mix["sample_clips"]), rows)
        picks = [(p // self.batch, p % self.batch, None) for p in
                 sorted(self.rng(4).choice(rows, size=n, replace=False))]
        return self.checks(score_gap=compare.score_gap(
            self.scores(picks, compare.fp8), self.scores(picks)))

    def check(self) -> list:
        picks = self.sample()
        served = torch.stack([s for _, _, s in picks])
        return self.checks(score_gap=compare.score_gap(served,
                                                       self.scores(picks)))
