"""A run with its timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program at a tiny size on the
CPU, with the cell's own limits. The harness's look for a card is the only
part of a run left out (``run.measure`` is the rest of it)."""

import glob
import os
import time

import pytest
import torch

from port_bench import manifest, run
from port_bench.tests import tiny

BENCH = manifest.benchmark()
# every cell file whose limits are all set, by the kind of its traffic
CELLS = {}
for path in sorted(glob.glob(os.path.join(manifest.HERE, "workloads",
                                          "*.json"))):
    name = os.path.basename(path)[:-len(".json")]
    spec, mix, _ = manifest.cell_files(name)
    if all(v is not None for v in spec["limits"].values()):
        CELLS.setdefault(mix["kind"], []).append(name)
SERVING = CELLS.get("serve_batch", []) + CELLS.get("request", [])
TRAINING = CELLS.get("train_step", [])


def _driver(cell, **mix):
    """The cell at a tiny size with its own limits; a serving cell compares
    every answer of the window."""
    spec, _, _ = manifest.cell_files(cell)
    if cell in SERVING:
        mix.setdefault("sample_clips", 10 ** 6)
    return tiny.driver(spec["config"], spec["traffic"],
                       limits=spec["limits"], **mix)


def _correct(d, cell):
    out = run.measure(d, 0.2, False, manifest.end_to_end(BENCH, cell),
                      manifest.per_layer(BENCH, cell), time.time())
    return run.correct(out["checks"])


def _break_forward(d, fault):
    setup = d.setup

    def broken_setup():
        setup()
        forward = d.forward

        def swapped(x):  # every answer's classes in reverse order
            return forward(x).flip(1)

        def half(x):  # the second half of the batch left out
            h = x[0].shape[0] // 2
            out = forward([t[:h] for t in x])
            return torch.cat([out, out])[:x[0].shape[0]]

        d.forward = {"altered answer": swapped, "half batch": half}[fault]

    d.setup = broken_setup


@pytest.mark.parametrize("cell", SERVING)
def test_sound_serving_run_is_correct(cell):
    assert _correct(_driver(cell), cell)


@pytest.mark.parametrize("fault", ["altered answer", "half batch"])
@pytest.mark.parametrize("cell", SERVING)
def test_serving_faults_are_not_correct(cell, fault):
    d = _driver(cell)
    _break_forward(d, fault)
    assert not _correct(d, cell)


def _break_step(d, fault):
    if fault == "state unchanged":
        original = d.setup

        def broken_setup():
            import port_bench.program as program

            make = program.train_step

            def train_step(cfg, net, device):
                state, step = make(cfg, net, device)
                state.optimizer.step = lambda *a, **k: None
                return state, step

            program.train_step = train_step
            try:
                original()
            finally:
                program.train_step = make

        d.setup = broken_setup
    elif fault == "half batch":
        run_step = d._run_step

        def half():
            fn = d.step_fn
            h = d.batch // 2
            d.step_fn = lambda state, x, y, lr, generator=None: fn(
                state, [t[:h] for t in x], y[:h], lr, generator=generator)
            try:
                return run_step()
            finally:
                d.step_fn = fn

        d._run_step = half
    else:  # the logits altered where the model produces them
        original = d.setup

        def broken_setup():
            import port_bench.program as program

            make = program.model

            def model(cfg, state_dict, device):
                net = make(cfg, state_dict, device)
                net.head.register_forward_hook(
                    lambda m, args, out: out + torch.arange(
                        out.shape[-1], dtype=out.dtype) * 0.1)
                return net

            program.model = model
            try:
                original()
            finally:
                program.model = make

        d.setup = broken_setup


@pytest.mark.parametrize("fault", ["state unchanged", "half batch",
                                   "altered answer"])
@pytest.mark.parametrize("cell", TRAINING)
def test_training_faults_are_not_correct(cell, fault):
    d = _driver(cell, checked_steps=1)
    _break_step(d, fault)
    assert not _correct(d, cell)
