"""One caller in a closed loop: each request is a few clips resident on
the device, sent through the serving entry, and ends when its float32
scores are on the host. Reports the 95th percentile of the requests'
latencies in the window; each request's enqueue time (the host's time in
the call before it returns) is kept for the per-layer metrics."""

from __future__ import annotations

import time

import numpy as np

from port_bench.serving import ServingDriver


class Driver(ServingDriver):
    traced_iterations = 40

    def setup(self) -> None:
        super().setup()
        self.latency, self.enqueue = [], []

    def step(self) -> int:
        i = len(self.answers) % len(self.pool)
        t0 = time.perf_counter()
        out = self.forward(self.pool[i])
        t1 = time.perf_counter()
        scores = out.cpu()
        t2 = time.perf_counter()
        self.answers.append((i, scores))
        self.latency.append(t2 - t0)
        self.enqueue.append(t1 - t0)
        return 1

    def results(self, window) -> dict:
        n = window.iterations
        return {"request_ms_p95":
                float(np.percentile(self.latency[:n], 95)) * 1e3}
