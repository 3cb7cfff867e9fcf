"""Closed-loop batch inference: back-to-back batches through the serving
entry, from a pool of distinct seeded batches resident on the device, at
most two batches queued ahead of the host. Reports the clips completed in
the window over its length, the last batch synchronised."""

from __future__ import annotations

from port_bench.serving import ServingDriver


class Driver(ServingDriver):
    def step(self) -> int:
        i = len(self.answers) % len(self.pool)
        self.answers.append((i, self.forward(self.pool[i])))
        self.bound_queue()
        return self.batch

    def results(self, window) -> dict:
        return {"serve_clips_per_s": window.units / window.seconds}
