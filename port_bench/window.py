"""The measured window: iterations of a driver's step until ``seconds``
have passed on the host's clock, then the device synchronised; the units
are all those completed and the length runs to that synchronisation."""

from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass
class Window:
    units: int
    iterations: int
    seconds: float


def run(driver, seconds: float) -> Window:
    driver.sync()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    units = iterations = 0
    while time.perf_counter() < deadline:
        units += driver.step()
        iterations += 1
    driver.sync()
    return Window(units, iterations, time.perf_counter() - t0)
