"""What every traffic kind shares: the run's context, the weights and
pool of inputs drawn from the seed, and the device's synchronisation.

A traffic kind (``traffic/<kind>.py``) subclasses ``Driver``:
``setup()`` builds the program and warms up every shape it will use;
``step()`` is one iteration of the window and returns the units it
completed; ``results(window)`` gives the end-to-end metrics; ``release()``
frees the program's state; ``check()`` runs the plain reference and returns
the compared numbers, each with its limit.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from . import program, recipe
from .reference.model import arch_from, param_spec


class Driver:
    # iterations of the profiler pass of a traced run
    traced_iterations = 4

    def __init__(self, cell: dict, mix: dict, config: dict, seed: int,
                 device):
        self.cell, self.mix, self.config = cell, mix, config
        self.seed = int(seed)
        self.device = torch.device(device)
        self.arch = arch_from(config["cfg"])
        self.spec = param_spec(self.arch)
        self.cfg = program.port_cfg(config)
        self.crop = int(program.lookup(self.cfg, mix["crop"]))
        self.batch = int(mix["batch"])
        self.limits = cell.get("limits", {})
        self._events = []

    # -- the device ------------------------------------------------------
    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def bound_queue(self, depth: int = 2) -> None:
        """Keep at most ``depth`` iterations queued on the device ahead of
        the host: a closed loop."""
        if not self.cuda:
            return
        evt = torch.cuda.Event()
        evt.record()
        self._events.append(evt)
        if len(self._events) > depth:
            self._events.pop(0).synchronize()

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def free(self, *names) -> None:
        for name in names:
            if hasattr(self, name):
                delattr(self, name)
        self._events = []
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    # -- what the seed draws ---------------------------------------------
    def generator(self, *stream) -> torch.Generator:
        return recipe.generator(self.device, self.seed, *stream)

    def weights(self) -> dict:
        """The seeded, calibrated float32 weights (the reference's copy)."""
        w = recipe.make_weights(self.spec, self.seed, self.device)
        clip = recipe.clips(self.arch, 1, self.crop, self.generator(2),
                            self.device)
        recipe.calibrate(self.arch, w, clip)
        return w

    def inputs(self, count: int) -> list:
        return [recipe.clips(self.arch, self.batch, self.crop,
                             self.generator(3, i), self.device)
                for i in range(count)]

    def rng(self, *stream) -> np.random.Generator:
        return np.random.default_rng(recipe.sub_seed(self.seed, *stream))

    def checks(self, **values) -> list:
        """[(name, value, limit)]: each number with the cell's limit for it
        (NaN where the cell has none, which no number passes)."""
        out = []
        for name, value in values.items():
            limit = self.limits.get(name)
            out.append((name, value, float("nan") if limit is None
                        else float(limit)))
        return out
