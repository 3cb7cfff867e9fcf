"""Run one cell of the port's benchmark once and print its result line.

    python port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Set-up (CUDA, the kernels' libraries, the seeded weights and inputs,
the warm-up) counts as ``setup_s``; then the window runs for ``--seconds``.
With ``--trace 0`` the line holds the cell's end-to-end metrics; with
``--trace 1`` a profiler pass follows the window, and the line holds the
per-layer metrics, the device's busy and traced seconds, and the
breakdown. Then the program is freed and the plain reference checks a
sample of what the timed path produced: each compared number and its limit
are printed last on standard error and last in the line, and decide
``correct``. The last line of standard output is the result, a JSON
object.
"""

import time

_T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the modules a run may not hold when its result is printed: the JAX
# package and JAX itself, compared by whole top-level names
FORBIDDEN = {"jax", "jaxlib", "flax", "efficient_slowfast_tpu"}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Run:
    """What a metric's reader reads: the driver, the window and (traced)
    the trace."""

    def __init__(self, driver, window, trace=None):
        self.driver, self.window, self.trace = driver, window, trace


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def correct(checks) -> bool:
    """Every compared number finite and within its limit."""
    return all(math.isfinite(v) and v <= limit for _, v, limit in checks)


def measure(driver, seconds: float, trace: bool, end_to_end: list,
            per_layer: list, started: float) -> dict:
    """Set-up, window, optional profiler pass, check: the result's fields
    (``checks`` a list of (name, value, limit)). ``end_to_end`` and
    ``per_layer`` are the cell's metrics as ``BENCHMARK.json`` lists them."""
    from port_bench import manifest, window
    from port_bench import trace as tracing

    driver.setup()
    setup_s = time.time() - started
    win = window.run(driver, seconds)
    peak = driver.peak_bytes()
    e2e = dict(driver.results(win), setup_s=setup_s)
    metrics, out = {}, {"device": {"memory_peak_bytes": peak}}
    if trace:
        traced = tracing.profile(driver.step, driver.traced_iterations,
                                 driver.sync)
        run = Run(driver, win, traced)
        for m in per_layer:
            value = manifest.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
        out["breakdown"] = traced.breakdown()
    else:
        for m in end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    out.update(attempted=win.units, failed=0, metrics=metrics)
    driver.release()
    out["checks"] = driver.check()
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from port_bench import manifest

    bench = manifest.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    cell, mix, config = manifest.cell_files(args.workload)
    driver = manifest.driver_class(mix["kind"])(cell, mix, config, args.seed,
                                                torch.device("cuda"))
    out = measure(driver, args.seconds, bool(args.trace),
                  manifest.end_to_end(bench, args.workload),
                  manifest.per_layer(bench, args.workload), _T0)
    bad = forbidden_modules()
    if bad:
        print("loaded modules of JAX or the JAX package: " + ", ".join(bad),
              file=sys.stderr)
        return 4
    checks = out.pop("checks")
    out["device"].update(platform="gpu", kind=torch.cuda.get_device_name(0),
                         count=chips)
    print(f"card: {power_limit()}", file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    line = {"correct": correct(checks), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": out["device"]}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in checks}
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
